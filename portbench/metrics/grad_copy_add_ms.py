"""Device milliseconds, per particle sweep of likelihood-and-gradient
evaluations (N evaluations) in the traced slice, of device-to-device
copies and elementwise adds: autograd's accumulation of the march's
block cotangents and its in-place folds."""
LAYER = "transient gradient"
UNIT, SOURCE, MOVES = "ms", "device_trace", "evals_per_s.march"


def _copy_or_add(name):
    """A copy on the device (the runtime's "Memcpy DtoD", or its copy
    kernel, "memcpy128" and the like), or an add kernel."""
    low = name.lower()
    if "memcpy" in low:
        return "dtoh" not in low and "htod" not in low
    return "add" in low.replace("address", "")


def read(run):
    sl = run.slice
    if sl is None or not sl["evals"]:
        return None
    us = sum(t for name, (t, _) in sl["kernels"].items()
             if _copy_or_add(name))
    return us * 1e-3 / (sl["evals"] / run.n_particles)
