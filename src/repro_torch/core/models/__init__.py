"""The ported click models (paper Appendix A). PBM, CM, UBM and the mixture
model are still to port (ROADMAP queue A)."""
from repro_torch.core.models.chain import (ClickChainModel,
                                           DependentClickModel,
                                           DynamicBayesianNetwork,
                                           SimplifiedDBN)
from repro_torch.core.models.ctr import DocumentCTR, GlobalCTR, RankCTR

MODEL_REGISTRY = {
    "gctr": GlobalCTR,
    "rctr": RankCTR,
    "dctr": DocumentCTR,
    "dcm": DependentClickModel,
    "ccm": ClickChainModel,
    "dbn": DynamicBayesianNetwork,
    "sdbn": SimplifiedDBN,
}

__all__ = [
    "GlobalCTR", "RankCTR", "DocumentCTR", "DependentClickModel",
    "ClickChainModel", "DynamicBayesianNetwork", "SimplifiedDBN",
    "MODEL_REGISTRY",
]
