"""Pallas solver kernels for the GPU, compiled through Triton."""

from .beta_pallas import beta_mu_iterations_pallas, kl_mu_iterations_pallas
from .cd_pallas import cd_iterations_pallas, fit_cd_pallas
from .mu_pallas import fit_mu_pallas, mu_iterations_pallas

__all__ = [
    "mu_iterations_pallas",
    "fit_mu_pallas",
    "cd_iterations_pallas",
    "fit_cd_pallas",
    "kl_mu_iterations_pallas",
    "beta_mu_iterations_pallas",
]
