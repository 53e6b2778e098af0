"""smc_tpu_torch: the PyTorch/CUDA port of smc-tpu.

Likelihood-tempered Sequential Monte Carlo with residual-systematic
resampling and adaptive random-walk Metropolis mutation, on torch tensors.
The JAX package ``smc_tpu`` beside it is the reference; nothing here imports
it or JAX. Entry points run on CUDA unless the caller passes
``device="cpu"``. On CUDA the likelihood (``method="pallas_exact"``), the
gamma ladder and the ancestor build run on hand-written Hopper kernels
(``smc_tpu_torch/csrc``); on the CPU their plain PyTorch versions run.
"""
import torch

# Full fp32 in every matrix product: TF32 would cut the proposal
# covariance and its Cholesky factor to 10-bit mantissas.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from smc_tpu_torch.config import SMCConfig  # noqa: E402
from smc_tpu_torch.priors import Prior  # noqa: E402
from smc_tpu_torch.rng import Draws, TorchDraws  # noqa: E402
from smc_tpu_torch.smc.state import SMCState  # noqa: E402
from smc_tpu_torch.smc.driver import (init_state,  # noqa: E402
                                      make_full_run_on_device, run_smc,
                                      run_smc_on_device, smc_step)
from smc_tpu_torch.smc.kernels import (find_gamma,  # noqa: E402
                                       make_mutation_sweeper, mh_mutation,
                                       mutate, residual_systematic_apply)

__version__ = "0.1.0"
