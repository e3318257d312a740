"""Style/content perceptual loss, the first approach's masked MSE and the
mesh regularizers (counterpart of ``st3d/ops/losses.py``).

Reference quirks kept exactly: the Gram is UNNORMALISED, the per-layer
style divisor is ``C**2 * H**2`` (height squared, not H*W), computed in
float, the content loss is a plain mean MSE on conv4_2, and the texture
target ignores ``main_loss_weight``. The regularizers are the
``pytorch3d.loss`` functions the reference calls (edge length, uniform
Laplacian smoothing, normal consistency) over the mesh's precomputed
topology.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from st3d_torch.core.mesh import Mesh
from st3d_torch.kernels.conv import gram_nhwc_diff
from st3d_torch.models.vgg import VGG19, get_features
from st3d_torch.utils import trace

STYLE_LAYERS = ("conv1_1", "conv2_1", "conv3_1", "conv4_1", "conv5_1")
CONTENT_LAYER = "conv4_2"


def gram_matrix_nhwc(tensor: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) taps in any dtype -> (B, C, C) float32 Grams, taken from
    the tap in its own dtype with float32 accumulation (kernel K3 on CUDA
    tensors)."""
    return gram_nhwc_diff(tensor)


def gram_matrix(tensor: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, C), unnormalised."""
    return gram_matrix_nhwc(tensor.permute(0, 2, 3, 1))


def mse_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean squared error (torch.nn.functional.mse_loss, mean reduction)."""
    return torch.mean((a - b) ** 2)


@dataclasses.dataclass
class StyleContentTargets:
    """Precomputed optimisation targets: conv4_2 content features and the
    style Grams, hoisted out of the step loop."""

    content_features: torch.Tensor
    style_grams: Dict[str, torch.Tensor]
    feature_shapes: Dict[str, tuple]

    @classmethod
    def create(cls, content_imgs: torch.Tensor, style_imgs: torch.Tensor,
               model: VGG19, dtype: torch.dtype = torch.float32,
               layout: str = "NCHW") -> "StyleContentTargets":
        """Targets from NCHW content and style images; ``layout="NHWC"``
        keeps the content features NHWC in the compute dtype."""
        with torch.no_grad():
            content = get_features(content_imgs, model, dtype=dtype,
                                   layout=layout)[CONTENT_LAYER]
            style = get_features(style_imgs, model, dtype=dtype,
                                 layout=layout)
            if layout == "NHWC":
                grams = {l: gram_matrix_nhwc(style[l]) for l in STYLE_LAYERS}
            else:
                grams = {l: gram_matrix(style[l]) for l in STYLE_LAYERS}
        shapes = {l: tuple(style[l].shape) for l in STYLE_LAYERS}
        return cls(content_features=content, style_grams=grams,
                   feature_shapes=shapes)


@trace.spanned("loss")
def style_content_loss(current_features: Dict[str, torch.Tensor],
                       targets: StyleContentTargets,
                       style_weight: float = 1e6,
                       content_weight: float = 1.0,
                       layout: str = "NCHW") -> torch.Tensor:
    """content_weight * Lc + style_weight * Ls with the reference formulas.
    ``layout`` must match the features' and targets' layout."""
    cur = current_features[CONTENT_LAYER].float()
    tgt = targets.content_features.float()
    content_loss = mse_loss(cur, tgt)
    style_loss = 0.0
    for layer in STYLE_LAYERS:
        if layer + ":gram" in current_features:
            g = current_features[layer + ":gram"]
            shape = targets.feature_shapes[layer]
            c, h = ((shape[3], shape[1]) if layout == "NHWC"
                    else (shape[1], shape[2]))
        elif layout == "NHWC":
            feat = current_features[layer]
            c, h = feat.shape[3], feat.shape[1]
            g = gram_matrix_nhwc(feat)
        else:
            feat = current_features[layer]
            c, h = feat.shape[1], feat.shape[2]
            g = gram_matrix(feat)
        layer_loss = torch.mean((g - targets.style_grams[layer]) ** 2)
        style_loss = style_loss + layer_loss / (float(c) ** 2 * float(h) ** 2)
    return content_weight * content_loss + style_weight * style_loss


def compute_perceptual_loss(current_imgs: torch.Tensor,
                            content_imgs: torch.Tensor,
                            style_imgs: torch.Tensor, model: VGG19,
                            style_weight: float = 1e6,
                            content_weight: float = 1.0) -> torch.Tensor:
    """Reference-signature perceptual loss on NCHW images: the targets and
    the current features are all extracted here (float32, NCHW taps).
    Prefer ``StyleContentTargets`` hoisted out of a step loop."""
    if not (current_imgs.shape[0] == content_imgs.shape[0]
            == style_imgs.shape[0]):
        raise ValueError("current, content and style batches differ in size")
    targets = StyleContentTargets.create(content_imgs, style_imgs, model)
    return style_content_loss(get_features(current_imgs, model), targets,
                              style_weight, content_weight)


def _require_topology(mesh: Mesh):
    if mesh.topology is None:
        raise ValueError(
            "mesh has no precomputed topology; call mesh.with_topology() "
            "once at load time before using the mesh regularizers")
    return mesh.topology


def mesh_edge_loss(mesh: Mesh, target_length: float = 0.0) -> torch.Tensor:
    """Mean over unique edges of (|v0 - v1| - target)^2."""
    topo = _require_topology(mesh)
    v = mesh.verts[topo.edges]                      # (E, 2, 3)
    length = torch.linalg.norm(v[:, 0] - v[:, 1], dim=-1)
    return torch.mean((length - target_length) ** 2)


def mesh_laplacian_smoothing(mesh: Mesh) -> torch.Tensor:
    """Uniform Laplacian: mean over vertices with neighbours of
    |(sum of neighbours) / degree - v|."""
    topo = _require_topology(mesh)
    verts = mesh.verts
    e0, e1 = topo.edges[:, 0], topo.edges[:, 1]
    nbr_sum = torch.zeros_like(verts).index_add(0, e0, verts[e1])
    nbr_sum = nbr_sum.index_add(0, e1, verts[e0])
    deg = torch.clamp(topo.degree[:, None], min=1.0)
    norm = torch.linalg.norm(nbr_sum / deg - verts, dim=-1)
    has = topo.degree > 0
    norm = torch.where(has, norm, torch.zeros_like(norm))
    return torch.sum(norm) / torch.clamp(has.sum(), min=1)


def mesh_normal_consistency(mesh: Mesh) -> torch.Tensor:
    """Mean over face pairs of a shared edge of 1 - cos(n0, n1), with
    n0 = (v1-v0) x (a-v0) and n1 = -(v1-v0) x (b-v0)."""
    topo = _require_topology(mesh)
    pairs = topo.nc_pairs
    if pairs.shape[0] == 0:
        return torch.zeros((), device=mesh.verts.device)
    v0, v1 = mesh.verts[pairs[:, 0]], mesh.verts[pairs[:, 1]]
    a, b = mesh.verts[pairs[:, 2]], mesh.verts[pairs[:, 3]]
    n0 = torch.cross(v1 - v0, a - v0, dim=-1)
    n1 = -torch.cross(v1 - v0, b - v0, dim=-1)
    den = torch.linalg.norm(n0, dim=-1) * torch.linalg.norm(n1, dim=-1)
    cos = torch.sum(n0 * n1, dim=-1) / torch.clamp(den, min=1e-12)
    return torch.mean(1.0 - cos)


@trace.spanned("loss")
def mesh_regularizer_loss(mesh: Mesh, verts: torch.Tensor,
                          target_verts: torch.Tensor,
                          weights: Dict[str, float]) -> torch.Tensor:
    """The regularizer block both approaches add for the mesh and both
    targets."""
    loss = weights["mesh_verts_weight"] * mse_loss(verts, target_verts)
    loss = loss + weights["mesh_edge_loss_weight"] * mesh_edge_loss(mesh)
    loss = loss + (weights["mesh_laplacian_smoothing_weight"]
                   * mesh_laplacian_smoothing(mesh))
    return loss + (weights["mesh_normal_consistency_weight"]
                   * mesh_normal_consistency(mesh))


def _with_regularizers(main: torch.Tensor, verts, target_verts, mesh: Mesh,
                       weights: Dict[str, float],
                       opt_type: str) -> torch.Tensor:
    if opt_type == "texture":
        return main          # main_loss_weight deliberately ignored
    if opt_type in ("mesh", "both"):
        return (weights["main_loss_weight"] * main
                + mesh_regularizer_loss(mesh, verts, target_verts, weights))
    raise ValueError(f"unknown opt_type {opt_type!r}")


def compute_first_approach_loss(rendered: torch.Tensor, masks: torch.Tensor,
                                target_rendered: torch.Tensor,
                                verts: torch.Tensor,
                                target_verts: torch.Tensor, mesh: Mesh,
                                weights: Dict[str, float],
                                opt_type: str) -> torch.Tensor:
    """Masked MSE against the 2D-stylized targets, plus the regularizers
    for the mesh and both targets."""
    if opt_type not in ("texture", "mesh", "both"):
        raise ValueError(f"unknown opt_type {opt_type!r}")
    main = mse_loss(rendered * masks, target_rendered * masks)
    return _with_regularizers(main, verts, target_verts, mesh, weights,
                              opt_type)


def compute_second_approach_loss(current: torch.Tensor,
                                 content: torch.Tensor, style: torch.Tensor,
                                 model: VGG19, style_weight: float,
                                 content_weight: float, verts: torch.Tensor,
                                 target_verts: torch.Tensor, mesh: Mesh,
                                 weights: Dict[str, float], opt_type: str,
                                 targets: Optional[StyleContentTargets] = None
                                 ) -> torch.Tensor:
    """Perceptual loss on NCHW images, plus the regularizers for the mesh
    and both targets. Without ``targets`` the content and style features
    are extracted here."""
    if targets is None:
        main = compute_perceptual_loss(current, content, style, model,
                                       style_weight, content_weight)
    else:
        main = style_content_loss(get_features(current, model), targets,
                                  style_weight, content_weight)
    return _with_regularizers(main, verts, target_verts, mesh, weights,
                              opt_type)
