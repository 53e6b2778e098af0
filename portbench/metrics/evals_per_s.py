"""Particle likelihood evaluations of the Michaelis-Menten cells
completed in the window over all of its seconds (the host clock),
counted from each posterior's own ``total_lik_evals`` (each
population's in an ensemble), never from launches times lanes."""
UNIT, SOURCE, MOVES = "evals/s", "host_clock", None


def read(run):
    return run.evals / run.window_s
