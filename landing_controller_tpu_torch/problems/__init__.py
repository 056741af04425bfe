"""NLP transcriptions: the landing problems (kinodynamic and the srbm_lcp
family) and the phase-based free-contact-timing eeParam problem."""

from .eeparam import (
    EEParamConfig,
    EEParamParams,
    EEParamProblem,
    EEParamVars,
    default_eeparam_params,
    eeparam_problem,
)
from .landing import (
    LandingConfig,
    LandingParams,
    LandingProblem,
    LandingVars,
    ccc_problem,
    contact_scheduled_problem,
    kinodynamic_problem,
    kinodynamic_voltage_problem,
    sliding_problem,
    srbm_lcp_problem,
)

__all__ = ["EEParamConfig", "EEParamParams", "EEParamProblem", "EEParamVars", "LandingConfig",
           "LandingParams", "LandingProblem", "LandingVars", "ccc_problem",
           "contact_scheduled_problem", "default_eeparam_params", "eeparam_problem",
           "kinodynamic_problem", "kinodynamic_voltage_problem", "sliding_problem",
           "srbm_lcp_problem"]
