"""Model family: UpliftUpsampleTransformer (nn.Module) and its primitives."""

from .uplift_upsample import UpliftUpsampleTransformer  # noqa: F401
from .build import build_uplift_upsample_transformer  # noqa: F401
