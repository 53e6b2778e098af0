from smc_tpu_torch.io.rundir import RunDir
from smc_tpu_torch.io.checkpoint import save_state, load_state
from smc_tpu_torch.io.csvio import save_posterior_csv, save_particles_csv
