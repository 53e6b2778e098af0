"""Work of one launch of the block-Thomas factor and of its solve
(``csrc/thomas_factor.cu`` and ``csrc/thomas_apply.cu`` today), counted
from the algorithm on 7 x 7 blocks, never from a kernel's instructions.

Shape keys: ``nx`` grid points, ``lanes`` independent systems.

Bytes: every input read once and every output written once, at 7
columns. The factor reads A[1:], B and C[:-1] and writes the LU factors
of the Schur diagonal blocks and the multipliers; the solve reads the LU
factors, the multipliers m[1:], C[:-1] and the right-hand side and
writes x.

Operations per lane (a multiply-add counted once, a division once, so a
floor): the factor, per grid row after the first, w U = A 196, m L = w
147, B - m C 343, the LU 112 and 13 divisions, and the first row's LU
(112 + 6); the solve, the forward sweep 56 a row, the backward 56 for
C x and the subtraction, 49 + 7 for the LU solve with its 7 divisions.
The kernels are bound by bytes at every size the benchmark runs.
"""

BLOCK = 49 * 4          # one 7 x 7 float32 block
VEC = 7 * 4             # one 7-vector


def work(kernel: str, shape: dict) -> dict:
    nx, lanes = shape["nx"], shape["lanes"]
    if kernel == "thomas_factor":
        nbytes = BLOCK * lanes * ((nx - 1) + nx + (nx - 1) + 2 * nx)
        ops = (196 + 147 + 343 + 112 + 13) * (nx - 1) + 112 + 6
    elif kernel == "thomas_apply":
        nbytes = (BLOCK * lanes * (nx + 2 * (nx - 1))
                  + 2 * VEC * lanes * nx)
        ops = 168 * (nx - 1) + 56 + 7 * nx
    else:
        raise KeyError(kernel)
    return {"flops": float(ops * lanes), "bytes": float(nbytes)}
