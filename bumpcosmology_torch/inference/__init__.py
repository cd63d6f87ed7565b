"""L2 priors, potential, joint likelihood and NUTS sampling; see the JAX package's ``inference``."""
from bumpcosmology_torch.inference.distributions import Normal, TruncatedNormal, Uniform
from bumpcosmology_torch.inference.model import (
    ModelSpec,
    make_potential,
    prior_sample,
    constrain,
    unconstrain,
)
from bumpcosmology_torch.inference.likelihoods import (
    EventData,
    SelectionData,
    PopData,
    PopCosmoData,
    make_pop_data,
    make_pop_cosmo_data,
    pop_loglike,
    pop_cosmo_loglike,
    pop_deterministics,
    pop_cosmo_deterministics,
    pop_model_spec,
    pop_cosmo_model_spec,
    POP_PRIORS,
    POP_COSMO_PRIORS,
)
from bumpcosmology_torch.inference.influence import (
    LooResult,
    influence_summary,
    loo_fit,
    make_loo_datas,
)
from bumpcosmology_torch.inference.evidence import (
    EvidenceResult,
    bayes_factor_table,
    log_evidence_bridge,
)
