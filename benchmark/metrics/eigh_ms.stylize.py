"""Device time a cascade of the WCT's eigendecompositions, ms an image: the
kernels, copies and sets launched inside the program's ``cd.eigh`` span
(each stage's content and style covariances), whichever solver runs there
(the port's ``sym_eigh`` kernel, ``torch.linalg.eigh``), each device event
once (``benchlib/trace.py``: ``spans_s``)."""
from benchlib.shares import span_ms


def read(r: dict):
    return span_ms(r, "cd.eigh")
