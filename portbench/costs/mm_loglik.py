"""Work of one launch of the closed-form Michaelis-Menten likelihood
(``csrc/mm_exact.cu`` today), counted from the formula, never from a
kernel's instructions.

Shape keys: ``b`` populations, ``n`` particles each, ``n_ds`` datasets of
``n_obs`` points (the first point is t = 0, where S = S0).

Per particle (once): 1/Km, Vmax dt / Km, exp(-Vmax dt / Km), ln Km, and
at the end ln sigma, the constant term and the residual sum's scaling:
10 operations.

Per particle and dataset (once): ln S0, the affine ln z(0), exp, the
residual of the t = 0 point and its square: 6 operations.

Per particle, dataset and later point (n_obs - 1 of them), the plain
closed form S = Km W(z), z(t) = z(t - dt) exp(-Vmax dt / Km):
- z and ln z advance: 2;
- W's starting value, a [3/3] rational in z (or in ln z): 6 multiply-adds
  (12 operations) and 1 division;
- one Halley step: exp w (1), f = w e^w - z (2), (w + 2) f (2),
  2w + 2 (2), their quotient (1), e^w (w + 1) (2), minus it (1),
  f / denom (1), w - that (1): 13;
- the residual: S0 - Km W (2), obs - P (1), r^2 + acc (2): 5.
That is 33 operations, each division, exponential and logarithm counted
as one, which is fewer than the chip spends on them: the count is a
floor, so the share it gives can only read low.

Bytes: theta (3 floats) in and ll (1 float) out per particle, the
observations and initial substrates once per population.
"""

PER_POINT = 2 + 12 + 1 + 13 + 5
PER_DATASET = 6
PER_PARTICLE = 10


def work(kernel: str, shape: dict) -> dict:
    b, n, n_ds, n_obs = (shape[k] for k in ("b", "n", "n_ds", "n_obs"))
    lanes = b * n
    flops = lanes * (PER_PARTICLE + n_ds * (PER_DATASET
                                            + (n_obs - 1) * PER_POINT))
    nbytes = 4 * (lanes * (3 + 1) + b * (n_ds * n_obs + n_ds))
    return {"flops": float(flops), "bytes": float(nbytes)}
