"""Lazy Gaussian-process Bayesian optimization in PyTorch (counterpart of
`repro.core`).

Public API:
  * kernels: Matérn-2.5/1.5, RBF, mixed — `repro_torch.core.kernels`
  * mixed-space typing + projection: `repro_torch.core.descriptor`
  * lazy Cholesky: `repro_torch.core.cholesky` (Alg. 2 naive, Alg. 3 append)
  * GP state machine: `repro_torch.core.gp`
  * acquisition + top-t local maxima: `repro_torch.core.acquisition`
  * neural-basis escalation tier: `repro_torch.core.neural_basis`
  * BO driver: `repro_torch.core.bayesopt`
  * synthetic objectives: `repro_torch.core.levy`
"""
from repro_torch.core.acquisition import (AcqConfig, cost_scaled,
                                          expected_improvement,
                                          optimize_acquisition)
from repro_torch.core.bayesopt import BayesOpt, BOConfig, BOHistory, run_bo
from repro_torch.core.cholesky import (cholesky_full, cholesky_naive,
                                       lazy_append_row, lazy_full_refactor,
                                       padded_trsv)
from repro_torch.core.descriptor import (TypeDescriptor, all_continuous,
                                         project_units)
from repro_torch.core.gp import (BackpressureError, GPCapacityError, GPConfig,
                                 LazyGPState, StudySaturatedError, append,
                                 append_batch, dense_posterior,
                                 ensure_capacity, init_state,
                                 log_marginal_likelihood, maybe_refit,
                                 posterior, refactor, refit_params)
from repro_torch.core.kernels import (KERNELS, KernelParams, gram,
                                      make_mixed_kernel, matern32, matern52,
                                      mixed_matern52, rbf)
from repro_torch.core.levy import levy, levy_1d, levy_bounds, neg_levy
from repro_torch.core.neural_basis import (NeuralBasisState, NeuralConfig,
                                           nb_from_data, nb_posterior)

__all__ = [
    "AcqConfig", "BackpressureError", "BayesOpt", "BOConfig", "BOHistory",
    "GPCapacityError", "GPConfig", "KERNELS", "KernelParams", "LazyGPState",
    "NeuralBasisState", "NeuralConfig",
    "StudySaturatedError", "TypeDescriptor", "all_continuous", "append",
    "append_batch", "cholesky_full",
    "cholesky_naive", "cost_scaled", "dense_posterior", "ensure_capacity",
    "expected_improvement", "gram", "init_state", "lazy_append_row",
    "lazy_full_refactor", "levy", "levy_1d", "levy_bounds",
    "log_marginal_likelihood", "make_mixed_kernel", "matern32", "matern52",
    "maybe_refit", "mixed_matern52", "nb_from_data", "nb_posterior",
    "neg_levy", "optimize_acquisition",
    "padded_trsv", "posterior", "project_units", "rbf",
    "refactor", "refit_params", "run_bo",
]
