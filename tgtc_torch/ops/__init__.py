"""Volume-rendering math core — port of tgtc/ops."""

from tgtc_torch.ops.composite import CompositeOutput, alpha_composite, sigma_weights
from tgtc_torch.ops.encoding import encoding_dim, positional_encoding
from tgtc_torch.ops.losses import cosine_similarity, img2mse, mse2psnr
from tgtc_torch.ops.sampling import (
    merge_and_resample_fine,
    sample_along_rays_uniform,
    sample_pdf,
)

__all__ = [
    "CompositeOutput", "alpha_composite", "sigma_weights", "encoding_dim",
    "positional_encoding", "cosine_similarity", "img2mse", "mse2psnr",
    "merge_and_resample_fine", "sample_along_rays_uniform", "sample_pdf",
]
