"""Landing NLP transcriptions (the srbm_lcp arm)."""

from .landing import LandingConfig, LandingParams, LandingProblem, LandingVars, srbm_lcp_problem

__all__ = ["LandingConfig", "LandingParams", "LandingProblem", "LandingVars", "srbm_lcp_problem"]
