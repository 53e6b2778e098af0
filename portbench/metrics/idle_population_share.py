"""The share of the MM kernel's particle lanes, over the window, that
evaluated no particle a posterior counts: 1 - (the populations'
``total_lik_evals`` summed) / (MM kernel launches x populations x N).
Lanes of populations already finished, or whose sweeps of a step are
done, are the idle ones."""
LAYER = "ensemble"
UNIT, SOURCE, MOVES = "%", "program_counter", "posteriors_per_s"


def read(run):
    shape = run.shapes.get("mm_loglik")
    launched = run.counters["launches"].get("mm_exact", 0)
    if not shape or not launched:
        return None
    lanes = launched * shape["b"] * shape["n"]
    return 100.0 * (1.0 - run.evals / lanes)
