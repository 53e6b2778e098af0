"""smc_tpu_torch: the PyTorch/CUDA port of smc-tpu.

Likelihood-tempered Sequential Monte Carlo with residual-systematic (or
systematic, stratified, multinomial) resampling and adaptive random-walk
Metropolis, preconditioned MALA or HMC mutation, on torch tensors; and
multi-start MAP estimation (``map_estimate``). The gradient kinds and MAP
differentiate the likelihood with ``torch.autograd``, so they need one it
differentiates (MM ``exact`` or ``rk4``, the methanation model, the
synthetic targets): the CUDA MM likelihood kernels have no backward and
refuse; the methanation march's block-Thomas kernels have one.
The JAX package ``smc_tpu`` beside it is the reference; nothing here imports
it or JAX. Entry points run on CUDA unless the caller passes
``device="cpu"``. On CUDA the Michaelis-Menten likelihoods
(``method="pallas_exact"`` and ``"pallas"``), the block-Thomas factor and
solves of the methanation DAE, the gamma ladder and the ancestor build run
on hand-written Hopper kernels (``smc_tpu_torch/csrc``); on the CPU their
plain PyTorch versions run. The hierarchical ensemble (``smc/ensemble.py``)
and the SBC harness on it (``smc/sbc.py``) run D populations through the
same kernels, one launch for all. On CUDA the run entry points replay the
SMC step's pieces as captured CUDA graphs (``smc/graphs.py``), backward
passes included, at step, sweep or block granularity; on the CPU the same
pieces run eagerly. Runs checkpoint and resume bit for bit (``io/``:
``.npz``, the native runtime's ``.smck``, ``.smcd`` in row slabs; the
JAX package's files load too), and user ODE and index-1 DAE models run
through ``models/generic.py`` (``rk4``, ``dopri5``, implicit ``bdf2``).
One run spans several processes, one per GPU (``parallel/``: a
``DeviceMesh`` of particles x data, explicit collectives on
``torch.distributed``; ``psharding=`` on the entry points).
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
from smc_tpu_torch.smc.driver import (StopRequested,  # noqa: E402
                                      init_state, make_block_step_fns,
                                      make_full_run_on_device,
                                      make_run_on_device, make_smc_step,
                                      make_sweep_step_fns, run_smc,
                                      run_smc_on_device, smc_step)
from smc_tpu_torch.smc.ensemble import (init_ensemble,  # noqa: E402
                                        make_ensemble_run,
                                        run_ensemble_on_device,
                                        run_ensemble_sweeps, take_datasets)
from smc_tpu_torch.smc.kernels import (find_gamma,  # noqa: E402
                                       hmc_mutation, mala_mutation,
                                       make_mutation_sweeper, mh_mutation,
                                       mutate, residual_systematic_apply,
                                       residual_systematic_resample)
from smc_tpu_torch.opt import MAPResult, map_estimate  # noqa: E402

__version__ = "0.1.0"
