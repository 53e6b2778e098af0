from smc_tpu_torch.utils.metrics import MetricsLogger, profile_trace
