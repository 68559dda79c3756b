"""TSDF fusion: the dense reference pass, the flat bricked path and the
brick-major rows."""
from tracking_sdf_tpu_torch.fusion.fuse import fuse_frame, make_fuse_fn, weighting
