"""Particle likelihood evaluations of the methanation march completed in
the window over all of its seconds (the host clock), counted from each
posterior's own ``total_lik_evals``; the window ends at the first step
boundary after its seconds, so no partial step is dropped or counted.
In a gradient cell each is a likelihood-and-gradient evaluation. Apart
from ``evals_per_s`` because the march's rate spreads far less between
runs than the host-paced Michaelis-Menten cells', and takes a tighter
bound."""
UNIT, SOURCE, MOVES = "evals/s", "host_clock", None


def read(run):
    return run.evals / run.window_s
