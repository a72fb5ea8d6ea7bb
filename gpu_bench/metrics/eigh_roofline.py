"""The eigensolver's share of its roofline, in percent: the least time the
step's eigenproblems need (`roofline/eigh.py`) over the device time of the
kernels named below. The problems are, per structure, one of order 3N per
optimizer step (the RFO step) and one of SQM2's band order per gradient the
calculator's span saw (a job's exact Hessian's displaced gradients
included)."""

from gpu_bench.roofline import eigh

# the Jacobi kernel's two variants, and the kernels of cuSOLVER's symmetric
# eigensolvers behind torch.linalg.eigh on the H100 (syevd: tridiagonal
# reduction, divide and conquer, back-transformation; syevj for batches)
KERNELS = ("jacobi_warp_kernel", "jacobi_block_kernel", "sytrd", "ormtr",
           "steqr", "laed", "merge_ker", "lansy_M", "syevd", "syevj")


def read(name, run):
    t = sum(s for k, s in run["trace"]["kernel_s"].items()
            if any(p in k for p in KERNELS))
    peak = eigh.PEAKS.get(run["card"])
    if t <= 0 or peak is None:
        return None
    problems = [(run["structure_steps"], run["dims"]["rfo"]),
                (run["gradients"], run["dims"]["band"])]
    return 100.0 * eigh.least_seconds(problems, run["itemsize"], peak) / t
