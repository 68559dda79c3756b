"""A render as a PNG of side-by-side panels (counterpart of
tracking_sdf_tpu.render.image_io): depth in grey (near bright, a miss
black), world normals as n * 0.5 + 0.5, and color when the render has it.
The PNG is written by the port's own encoder (data.tum.write_png)."""
from __future__ import annotations

import numpy as np

from tracking_sdf_tpu_torch.data.tum import write_png
from tracking_sdf_tpu_torch.render.raycast import RenderResult


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def render_panels(result: RenderResult) -> np.ndarray:
    """(H, W*k, 3) uint8 panel image of a RenderResult."""
    depth = _host(result.depth)
    finite = np.isfinite(depth)
    if finite.any():
        lo = float(np.percentile(depth[finite], 2))
        hi = float(np.percentile(depth[finite], 98))
        hi = hi if hi > lo else lo + 1.0
    else:
        lo, hi = 0.0, 1.0
    d01 = np.clip((depth - lo) / (hi - lo), 0.0, 1.0)
    d_img = np.where(finite, 1.0 - d01 * 0.9, 0.0)
    panels = [np.repeat(d_img[..., None], 3, axis=-1)]
    n = _host(result.normal_world)
    panels.append(np.where(np.isfinite(n), n * 0.5 + 0.5, 0.0))
    if result.rgb is not None:
        c = _host(result.rgb)
        panels.append(np.where(np.isfinite(c), c, 0.0))
    img = np.concatenate(panels, axis=1)
    return np.clip(img * 255.0, 0, 255).astype(np.uint8)


def save_render_png(result: RenderResult, path: str) -> None:
    write_png(path, render_panels(result))
