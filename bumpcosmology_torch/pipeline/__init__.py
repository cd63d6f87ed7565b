"""The pipeline of the port (L4/L6): ingestion, the fits, the mock universe,
calibration and model comparison as stages of an artifact-cached DAG, and
the CLI ``python -m bumpcosmology_torch.pipeline``."""
