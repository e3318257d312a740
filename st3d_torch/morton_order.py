"""K9's face order on one NVIDIA GPU: the JAX package's Morton codes against
codes that interleave all 10 quantised bits (ROADMAP F9).

    python -m st3d_torch.morton_order [--size 512] [--views 4] [--levels 4,7]

``_morton_codes`` in the JAX package (ported as
``kernels/raster.py::morton_codes``) quantises bbox centres to 10 bits but
its masks spread only the low 8, so its order repeats every 256 quantised
units and a 128-face chunk gathers faces from all over the mesh. For an
ico-sphere at each level under the fixed cameras this sorts the faces both
ways and prints, per order, the (tile, chunk) pairs K9's 2D cull keeps,
the (pixel, face) pairs G's warps' lists hold (its ``tested`` counter),
kernel G's time (CUDA events) and whether its zbuf equals K1's; beside them
K1's (tile, chunk) pairs and time on the same faces. Then one JSON line.
Raises without a GPU. The order changes only which face wins an exact 1/z
tie.
"""

from __future__ import annotations

import argparse
import json
from typing import Callable, Dict, Tuple

import torch

from st3d_torch.core.cameras import build_fixed_cameras
from st3d_torch.core.primitives import ico_sphere
from st3d_torch.kernels import raster as kr
from st3d_torch.render.rasterize import face_verts_screen


def full_spread_codes(cx: torch.Tensor, cy: torch.Tensor,
                      size: float) -> torch.Tensor:
    """``morton_codes`` with all 10 quantised bits of x and y interleaved
    (int32, below 2³⁰, so invalid faces still sort last)."""

    def spread(v):
        v = v & 0x3FF
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        return (v | (v << 2)) & 0x09249249

    qx = torch.clamp(cx / size * 1024.0, 0, 1023).to(torch.int32)
    qy = torch.clamp(cy / size * 1024.0, 0, 1023).to(torch.int32)
    return spread(qx) | (spread(qy) << 1)


def preprocess_full_spread(face_verts: torch.Tensor, image_size: int
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """``kr.preprocess_2d`` with the faces sorted by ``full_spread_codes``."""
    fv = face_verts.float()
    valid, (ymin, ymax, xmin, xmax) = kr._face_boxes(fv)
    code = full_spread_codes((xmin + xmax) * 0.5, (ymin + ymax) * 0.5,
                             float(image_size))
    code = torch.where(valid, code, torch.full_like(code, 2 ** 30))
    return kr._sort_and_chunk(fv, code, (ymin, ymax, xmin, xmax))


def _cuda_ms(fn: Callable[[], object], reps: int = 5, warmup: int = 1
             ) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def measure(level: int, size: int, views: int) -> Dict[str, object]:
    """The numbers of one level: faces, K1's pairs and ms, and per order
    (``reference``, ``full_spread``) G's pairs (tile and chunk; pixel and
    face), ms and zbuf check."""
    mesh = ico_sphere(level=level).to("cuda")
    cams = build_fixed_cameras(views, seed=0).to("cuda")
    fv = face_verts_screen(mesh.verts, mesh.faces, cams, size)
    c1, b1, _ = kr.preprocess(fv)
    _, z1 = kr.raster_hard(c1, b1, size, size)
    out: Dict[str, object] = {
        "level": level, "faces": int(fv.shape[1]),
        "k1_tile_chunk_pairs": int(kr._band_overlap(
            b1, size, size, kr.TILE_PIXELS, 0.0).sum()),
        "k1_ms": _cuda_ms(lambda: kr.raster_hard(c1, b1, size, size))}
    for name, prep in (("reference", kr.preprocess_2d),
                       ("full_spread", preprocess_full_spread)):
        coeffs, bounds, _ = prep(fv, size)
        tested = torch.zeros(1, dtype=torch.int64, device="cuda")
        _, z = kr.raster_2d(coeffs, bounds, size, size, tested)
        out[name] = {
            "tile_chunk_pairs": int(kr.cull_2d(bounds, size, size).sum()),
            "tested": int(tested),
            "ms": _cuda_ms(lambda: kr.raster_2d(coeffs, bounds, size, size)),
            "zbuf_equals_k1": bool(torch.equal(z, z1))}
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--views", type=int, default=4)
    ap.add_argument("--levels", default="4,7")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("morton_order times kernels G and K1 and needs "
                           "a CUDA device")
    rows = [measure(int(lv), args.size, args.views)
            for lv in args.levels.split(",")]
    for r in rows:
        print(f"level {r['level']} ({r['faces']} faces, {args.size}² x "
              f"{args.views}): K1 {r['k1_tile_chunk_pairs']} (tile, chunk) "
              f"pairs {r['k1_ms']:.3f} ms")
        for name in ("reference", "full_spread"):
            o = r[name]
            print(f"  G on the {name} order: {o['tile_chunk_pairs']} pairs, "
                  f"{o['tested']} (pixel, face) pairs tested, {o['ms']:.3f} "
                  f"ms, zbuf equals K1's {o['zbuf_equals_k1']}")
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "size": args.size, "views": args.views,
                      "levels": rows}))


if __name__ == "__main__":
    main()
