from smc_tpu_torch.parallel.multihost import (initialize_distributed,
                                              is_primary_host)
