"""The least time the symmetric eigenproblems of a step need on a card.

The count is the algorithm's and not an implementation's: 9 D^3
operations per matrix of order D, Golub and Van Loan's count for the
symmetric eigenproblem with eigenvectors (tridiagonal reduction 4/3 D^3,
accumulating it 4/3 D^3, implicit QR with vectors about 6 D^3); the matrix
read once, its values and vectors written once. Whatever eigensolver a
later version of the program uses, the same problems cost the same here.
"""

# NVIDIA's data sheet for the H100 SXM (dense, at the card's 700 W limit):
# 67 TFLOP/s in float32 outside the tensor cores, and as much in float64 on
# the tensor cores; 3.35 TB/s of HBM3.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"flop_per_s": 67e12, "byte_per_s": 3.35e12},
}


def flops(d):
    return 9 * d ** 3


def nbytes(d, itemsize):
    return itemsize * (2 * d * d + d)


def least_seconds(problems, itemsize, peak):
    """The larger of all operations over the peak rate and all bytes over
    the peak bandwidth, for `problems` a list of (count, order D)."""
    ops = sum(c * flops(d) for c, d in problems)
    byt = sum(c * nbytes(d, itemsize) for c, d in problems)
    return max(ops / peak["flop_per_s"], byt / peak["byte_per_s"])
