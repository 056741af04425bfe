"""Landing NLP transcriptions: kinodynamic and the srbm_lcp family."""

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

__all__ = ["LandingConfig", "LandingParams", "LandingProblem", "LandingVars", "ccc_problem",
           "contact_scheduled_problem", "kinodynamic_problem", "kinodynamic_voltage_problem",
           "sliding_problem", "srbm_lcp_problem"]
