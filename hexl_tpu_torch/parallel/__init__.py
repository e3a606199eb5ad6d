"""The parallel layer: sharded NTT and RNS pipelines over a mesh of torch
devices driven by one process (`mesh.py`), the coefficient-sharded
`DistNTT`, the stage-pipelined `PipelineNTT` and the sharded composites.
Not imported by the package's top level, as in the JAX package."""

from .composites import dist_dyadic_multiply, dist_key_switch
from .dist_ntt import (DistNTT, dist_rns_poly_mult, get_dist_ntt,
                       make_mesh)
from .pipeline import PipelineNTT, make_pipeline_mesh

__all__ = ["DistNTT", "PipelineNTT", "dist_dyadic_multiply",
           "dist_key_switch", "dist_rns_poly_mult", "get_dist_ntt",
           "make_mesh", "make_pipeline_mesh"]
