from smc_tpu_torch.viz.plots import (
    plot_marginal_histograms,
    plot_parity,
    plot_pairplot,
    plot_prior_posterior_compare,
)
