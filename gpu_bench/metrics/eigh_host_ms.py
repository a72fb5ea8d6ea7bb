"""Host milliseconds per optimizer step in the eigensolver's dispatch: the
self time of the program's `eigh` spans (the RFO step, the Loewdin
S^-1/2, the EEQ solve and the SQM2 band; K1 or torch.linalg.eigh, whose
error check waits for the card), recorded by the program
(`program_spans.py`)."""

from gpu_bench.program_spans import self_ms_per_step


def read(name, run):
    return self_ms_per_step(run, lambda n: n == "eigh")
