"""The port's Hopper kernels, each beside its plain-torch version (port of
``repro.kernels``): ``examination_nll``, ``session_nll``,
``embedding_bag``, ``flash_attention`` and ``dcn_cross`` in CUDA C++,
``fm_interaction`` in Triton, plus the public ops with autograd that route
by device; and the optimizer's two kernels, ``adamw`` (dense, one pass)
and ``sparse_adamw`` (lazy, touched rows only), in CUDA C++. ``session_nll_triton`` is ``session_nll``'s first design, kept
to be timed beside the CUDA kernel. Each wrapper's ``.launches`` counts the
launches it makes, none while the current stream is being captured into a
CUDA graph: the graph's replays run the kernel, with no wrapper.

Each wrapper checks its inputs and hands them to a registered op,
``torch.ops.repro_torch.<name>`` (``torch.library.custom_op``), whose body
launches the kernel (and counts the launch) and whose fake form makes only
the outputs' shapes and types: under ``FakeTensorMode`` (the dry run,
``TrainEngine.roofline``) a kernel is met as the op it is and nothing
launches. :mod:`repro_torch.kernels.cost` gives each op's work."""
from repro_torch.kernels.adamw import adamw_cuda
from repro_torch.kernels.dcn_cross import dcn_cross_cuda, dcn_cross_plain
from repro_torch.kernels.embedding_bag import (embedding_bag_cuda,
                                               embedding_bag_plain)
from repro_torch.kernels.examination_nll import (examination_nll_cuda,
                                                 examination_nll_plain)
from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                 flash_attention_plain)
from repro_torch.kernels.fm_interaction import (fm_interaction_plain,
                                                fm_interaction_triton)
from repro_torch.kernels.ops import (dcn_cross, embedding_bag,
                                     examination_nll, flash_attention,
                                     fm_interaction, session_nll)
from repro_torch.kernels.ref import (dcn_cross_ref, embedding_bag_ref,
                                     examination_nll_ref, flash_attention_ref,
                                     fm_interaction_ref, session_nll_ref)
from repro_torch.kernels.session_nll import (session_nll_cuda,
                                             session_nll_plain,
                                             session_nll_triton)
from repro_torch.kernels.sparse_adamw import (sparse_adamw_cuda,
                                              sparse_adamw_plain)

__all__ = [
    "adamw_cuda", "dcn_cross", "dcn_cross_cuda", "dcn_cross_plain", "dcn_cross_ref",
    "embedding_bag", "embedding_bag_cuda", "embedding_bag_plain",
    "embedding_bag_ref", "examination_nll", "examination_nll_cuda",
    "examination_nll_plain", "examination_nll_ref", "flash_attention",
    "flash_attention_cuda", "flash_attention_plain", "flash_attention_ref",
    "fm_interaction", "fm_interaction_plain", "fm_interaction_ref",
    "fm_interaction_triton", "session_nll", "session_nll_cuda",
    "session_nll_plain", "session_nll_ref", "session_nll_triton",
    "sparse_adamw_cuda", "sparse_adamw_plain",
]
