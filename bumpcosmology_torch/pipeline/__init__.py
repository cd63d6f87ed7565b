"""The pipeline stages of the port (L4/L6): the population-only and joint fits."""
