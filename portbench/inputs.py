"""The inputs of a run, made from its seed: the scene, the style images and
the VGG-19 weights, written as the files the port's CLI reads.

Everything is drawn on the run's device from one ``torch.Generator`` seeded
with ``--seed``, in a few large calls, so the same seed gives the same
inputs. The scene is an ico-sphere (level 4: 5,120 faces, 2,562 vertices)
with spherical UVs, one UV per face corner (faces across the seam take
``u + 1`` on their low side, and the sampler clamps), and a smooth seeded
texture; the styles are smooth seeded images at the render size; the VGG-19
weights are He-initialised (``N(0, 2 / (9 Cin))``) with small seeded biases
for the 13 convs up to conv5_1 and zeros for the three past it, which no
tap reaches. Files: ``mesh.obj`` (+ ``mesh.mtl``, ``mesh_texture.png``),
``style_<k>.png``, ``vgg19.npz`` (HWIO kernels ``conv{i}_kernel``, biases
``conv{i}_bias``). Floats are written so that they read back as the same
float32, so the arrays kept here are exactly what the program loads.
"""

from __future__ import annotations

import dataclasses
import os
import struct
import zlib
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from portbench.work import vgg_layers

PNG_SIG = b"\x89PNG\r\n\x1a\n"


@dataclasses.dataclass
class Inputs:
    """The arrays both sides start from (NumPy, on the host) and the files
    that hold them."""

    verts: np.ndarray          # (V, 3) float32
    faces: np.ndarray          # (F, 3) int64
    verts_uvs: np.ndarray      # (F*3, 2) float32, one per face corner
    faces_uvs: np.ndarray      # (F, 3) int64
    texture: np.ndarray        # (H, W, 3) uint8, row 0 at the top
    styles: List[np.ndarray]   # (H, W, 3) uint8 each
    vgg: Dict[str, np.ndarray]  # conv{i}_kernel HWIO, conv{i}_bias
    obj_path: str
    style_paths: List[str]
    vgg_path: str


def ico_sphere(level: int):
    """(verts (V, 3) float64 on the unit sphere, faces (F, 3) int64)."""
    t = (1.0 + 5 ** 0.5) / 2.0
    verts = [np.array(v, np.float64) for v in (
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0], [0, -1, t],
        [0, 1, t], [0, -1, -t], [0, 1, -t], [t, 0, -1], [t, 0, 1],
        [-t, 0, -1], [-t, 0, 1])]
    faces = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
             (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
             (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
             (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    for _ in range(level):
        mids: Dict[tuple, int] = {}

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in mids:
                verts.append((verts[a] + verts[b]) / 2.0)
                mids[key] = len(verts) - 1
            return mids[key]

        nxt = []
        for a, b, c in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            nxt += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = nxt
    v = np.stack(verts)
    return v / np.linalg.norm(v, axis=1, keepdims=True), np.array(
        faces, np.int64)


def corner_uvs(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Spherical (u, v) of every face corner, (F, 3, 2): v from the
    latitude, u from the longitude, unwrapped across the seam within a
    face, and a pole corner taking its face's other corners' mean u."""
    u = 0.5 + np.arctan2(verts[:, 2], verts[:, 0]) / (2 * np.pi)
    v = 0.5 + np.arcsin(np.clip(verts[:, 1], -1.0, 1.0)) / np.pi
    fu, fv = u[faces], v[faces]
    wrap = fu.max(axis=1) - fu.min(axis=1) > 0.5
    fu = np.where(wrap[:, None] & (fu < 0.5), fu + 1.0, fu)
    pole = np.abs(verts[faces][..., 1]) > 1.0 - 1e-9
    for k in range(3):
        others = [j for j in range(3) if j != k]
        fu[:, k] = np.where(pole[:, k], fu[:, others].mean(axis=1), fu[:, k])
    return np.stack([fu, fv], axis=-1)


def smooth_image(gen: torch.Generator, size: int, coarse: int,
                 device) -> np.ndarray:
    """(size, size, 3) uint8: seeded coarse noise upsampled bilinearly,
    plus fine noise."""
    low = torch.rand((1, 3, coarse, coarse), generator=gen, device=device)
    img = F.interpolate(low, size=(size, size), mode="bilinear",
                        align_corners=False)[0]
    img = 0.85 * img + 0.15 * torch.rand((3, size, size), generator=gen,
                                         device=device)
    img8 = torch.floor(img.clamp(0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
    return img8.permute(1, 2, 0).contiguous().cpu().numpy()


def vgg_weights(gen: torch.Generator, device) -> Dict[str, np.ndarray]:
    """He-initialised HWIO kernels and small biases for the convs up to
    conv5_1, zeros past it, drawn in one call."""
    convs = [(ci, co) for _, ci, co, _ in vgg_layers() if co]
    live = 13
    sizes = [9 * ci * co + co for ci, co in convs[:live]]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out, pos = {}, 0
    for i, (ci, co) in enumerate(convs):
        if i < live:
            k = flat[pos:pos + 9 * ci * co].reshape(3, 3, ci, co)
            b = flat[pos + 9 * ci * co:pos + sizes[i]]
            pos += sizes[i]
            k = k * float(np.sqrt(2.0 / (9 * ci)))
            b = b * 0.05
            out[f"conv{i}_kernel"] = k.float().cpu().numpy()
            out[f"conv{i}_bias"] = b.float().cpu().numpy()
        else:
            out[f"conv{i}_kernel"] = np.zeros((3, 3, ci, co), np.float32)
            out[f"conv{i}_bias"] = np.zeros((co,), np.float32)
    return out


def write_png(path: str, rgb8: np.ndarray) -> None:
    """An 8-bit RGB PNG, every row unfiltered."""
    h, w, _ = rgb8.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          np.ascontiguousarray(rgb8).reshape(h, w * 3)], 1)

    def chunk(tag: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(PNG_SIG
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw.tobytes(), 1))
                + chunk(b"IEND", b""))


def _f32(x) -> str:
    return format(float(np.float32(x)), ".9g")


def write_obj(path: str, verts, faces, verts_uvs, faces_uvs,
              texture: np.ndarray) -> None:
    """OBJ + MTL + texture PNG beside it; floats round-trip to float32."""
    base, stem = os.path.dirname(path), os.path.splitext(
        os.path.basename(path))[0]
    lines = [f"mtllib {stem}.mtl"]
    lines += [f"v {_f32(a)} {_f32(b)} {_f32(c)}" for a, b, c in verts]
    lines += [f"vt {_f32(a)} {_f32(b)}" for a, b in verts_uvs]
    lines.append("usemtl material_1")
    lines += [f"f {a + 1}/{ta + 1} {b + 1}/{tb + 1} {c + 1}/{tc + 1}"
              for (a, b, c), (ta, tb, tc) in zip(faces, faces_uvs)]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(os.path.join(base, f"{stem}.mtl"), "w") as f:
        f.write(f"newmtl material_1\nmap_Kd {stem}_texture.png\n")
    write_png(os.path.join(base, f"{stem}_texture.png"), texture)


def make_inputs(root: str, seed: int, size: int, styles: int, level: int,
                device) -> Inputs:
    """Draw and write every input of a run under ``root``."""
    os.makedirs(root, exist_ok=True)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    weights = vgg_weights(gen, device)
    texture = smooth_image(gen, size, 24, device)
    style_imgs = [smooth_image(gen, size, 8 + 8 * k, device)
                  for k in range(styles)]
    v64, faces = ico_sphere(level)
    verts = v64.astype(np.float32)
    uv = corner_uvs(v64, faces).astype(np.float32).reshape(-1, 2)
    faces_uvs = np.arange(faces.size, dtype=np.int64).reshape(-1, 3)
    obj = os.path.join(root, "mesh.obj")
    write_obj(obj, verts, faces, uv, faces_uvs, texture)
    style_paths = []
    for k, img in enumerate(style_imgs):
        style_paths.append(os.path.join(root, f"style_{k}.png"))
        write_png(style_paths[-1], img)
    vgg_path = os.path.join(root, "vgg19.npz")
    np.savez(vgg_path, **weights)
    return Inputs(verts=verts, faces=faces, verts_uvs=uv,
                  faces_uvs=faces_uvs, texture=texture, styles=style_imgs,
                  vgg=weights, obj_path=obj, style_paths=style_paths,
                  vgg_path=vgg_path)
