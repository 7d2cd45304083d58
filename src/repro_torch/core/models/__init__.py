"""The ten click models (paper Appendix A) and the mixture meta-model."""
from repro_torch.core.models.cascade import CascadeModel
from repro_torch.core.models.chain import (ClickChainModel,
                                           DependentClickModel,
                                           DynamicBayesianNetwork,
                                           SimplifiedDBN)
from repro_torch.core.models.ctr import DocumentCTR, GlobalCTR, RankCTR
from repro_torch.core.models.mixture import MixtureModel
from repro_torch.core.models.pbm import PositionBasedModel
from repro_torch.core.models.ubm import UserBrowsingModel

MODEL_REGISTRY = {
    "gctr": GlobalCTR,
    "rctr": RankCTR,
    "dctr": DocumentCTR,
    "pbm": PositionBasedModel,
    "cm": CascadeModel,
    "ubm": UserBrowsingModel,
    "dcm": DependentClickModel,
    "ccm": ClickChainModel,
    "dbn": DynamicBayesianNetwork,
    "sdbn": SimplifiedDBN,
}

__all__ = [
    "GlobalCTR", "RankCTR", "DocumentCTR", "PositionBasedModel",
    "CascadeModel", "UserBrowsingModel", "DependentClickModel",
    "ClickChainModel", "DynamicBayesianNetwork", "SimplifiedDBN",
    "MixtureModel", "MODEL_REGISTRY",
]
