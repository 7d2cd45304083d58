"""Loss kernels of the training slice: a CUDA C++ ``examination_nll`` and a
Triton ``session_nll``, each beside its plain-torch version (port of the
corresponding parts of ``repro.kernels``)."""
from repro_torch.kernels.examination_nll import (examination_nll_cuda,
                                                 examination_nll_plain)
from repro_torch.kernels.ops import examination_nll, session_nll
from repro_torch.kernels.ref import examination_nll_ref, session_nll_ref
from repro_torch.kernels.session_nll import (session_nll_plain,
                                             session_nll_triton)

__all__ = [
    "examination_nll", "examination_nll_cuda", "examination_nll_plain",
    "examination_nll_ref", "session_nll", "session_nll_plain",
    "session_nll_ref", "session_nll_triton",
]
