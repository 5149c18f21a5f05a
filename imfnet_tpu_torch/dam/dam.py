"""DAM, descriptor activation mapping (``imfnet_tpu.dam.dam``; reference
`pytorch_dam/`, `base_dam.py:105-188`, `dam.py:15-20`): a chosen point's
descriptor attributed back to the input points through the final 1x1 conv.

Per descriptor channel i:
  loss_i = F[target, i]  (the normalized descriptor)
  g_i    = d loss_i / d final.weight          ∈ [Cin, Cout]
  w_i    = mean over Cin of g_i               ∈ [Cout]
  dam_i  = Σ_c w_i[c] · final_output[:, c]    ∈ [N]
  DAM    = relu(Σ_i dam_i)

The reference backpropagates 32 times with ``retain_graph=True`` and never
zeroes the gradient between channels (`base_dam.py:141-160`), so channel i
sees the cumulative Σ_{j≤i} g_j; ``cumulative=True`` (the default) keeps
that, ``cumulative=False`` gives each channel its own gradient.

Only ``final`` and the normalization lie between ``final.weight`` and the
descriptor, so the model runs once, without a graph, and a forward hook on
``final`` keeps its input and output; the channel gradients are taken on
that tail alone, one ``torch.autograd.grad`` a channel on one row (the JAX
package takes ``jax.jacrev`` of the whole forward). The image saliency
differentiates the whole forward, through the decoder's sparse convs
(kernel A's dX on the card).
"""
from __future__ import annotations

import numpy as np
import torch


def _final_tail(model: torch.nn.Module, sv, pyramid, image):
    """(x, y, mask): the input and output rows of ``model.final`` and its
    output mask, from one forward without a graph."""
    final = getattr(model, "final", None)
    if final is None:
        raise ValueError(f"{type(model).__name__} has no 'final' 1x1 conv to attribute through")
    seen = {}

    def hook(_, args, out):
        seen["x"], seen["mask"], seen["y"] = args[0], args[2], out

    handle = final.register_forward_hook(hook)
    try:
        with torch.no_grad():
            model(sv, pyramid, image)
    finally:
        handle.remove()
    return seen["x"], seen["y"], seen["mask"]


def descriptor_activation_map(model: torch.nn.Module, sv, pyramid, image,
                              target_index: int, *, cumulative: bool = True) -> torch.Tensor:
    """Per-point attribution weights f32[N] for the descriptor of row
    ``target_index``, on the model's device; ``model`` is put in ``eval()``."""
    model.eval()
    x, y, mask = _final_tail(model, sv, pyramid, image)
    t = int(target_index)
    weight = model.final.weight
    with torch.enable_grad():
        row = model.final(x[t:t + 1], None, mask[t:t + 1])
        if model.normalize_feature:
            row = row / row.norm(dim=1, keepdim=True).clamp_min(1e-12) * mask[t:t + 1, None]
        jac = torch.stack([torch.autograd.grad(row[0, i], weight, retain_graph=True)[0]
                           for i in range(row.shape[1])])         # [Cdesc, Cin, Cout]
    if cumulative:
        jac = jac.cumsum(dim=0)
    weights = jac.mean(dim=1)                                     # [Cdesc, Cout]
    dams = weights @ y.T                                          # [Cdesc, N]
    return torch.relu(dams.sum(dim=0))


def image_activation_map(model: torch.nn.Module, sv, pyramid, image,
                         target_index: int) -> torch.Tensor:
    """Image-side attribution f32[H, W]: |∇_image Σ|F[target]|| × image,
    summed over RGB (grad × input). The image reaches the descriptor only
    through the bottleneck's cross-attention, so this shows where in the
    frame the fusion looked: the image-side complement of the point DAM
    (the reference's unused `show_cam_on_image`,
    `pytorch_dam/utils/image.py:81-104`)."""
    model.eval()
    img = image.detach().float().requires_grad_(True)
    # the parameters leave the graph for the call: a sparse conv's backward
    # would otherwise also form its weight's gradient, which nobody reads
    frozen = [p for p in model.parameters() if p.requires_grad]
    for p in frozen:
        p.requires_grad_(False)
    try:
        with torch.enable_grad():
            score = model(sv, pyramid, img)[int(target_index)].abs().sum()
            (g,) = torch.autograd.grad(score, img)
    finally:
        for p in frozen:
            p.requires_grad_(True)
    return (g * img.detach()).abs().sum(dim=-1)[0]


def dam_colors(weights: np.ndarray, num_valid: int) -> np.ndarray:
    """HSV-style heat colours, blue (cold) to red (hot), of the first
    ``num_valid`` weights (the PLY colouring of
    `pytorch_dam/utils/image.py:123-168`, without matplotlib)."""
    w = np.asarray(weights[:num_valid], np.float64)
    rng = w.max() - w.min()
    t = (w - w.min()) / (rng if rng > 0 else 1.0)
    h = (1.0 - t) * (240.0 / 360.0)
    hh = h * 6.0
    i = np.floor(hh).astype(int) % 6
    f = hh - np.floor(hh)
    p = np.zeros_like(t)
    q = 1.0 - f
    one = np.ones_like(t)
    r = np.choose(i, [one, q, p, p, f, one])
    g = np.choose(i, [f, one, one, q, p, p])
    b = np.choose(i, [p, p, f, one, one, q])
    return np.stack([r, g, b], axis=1)


def save_dam_ply(path: str, xyz: np.ndarray, weights: np.ndarray, num_valid: int) -> None:
    """The coloured attribution cloud (the reference's
    `files/3D_head_map.ply`, `dam.py:84-100`)."""
    from imfnet_tpu_torch.geom.ply import write_ply

    colors = dam_colors(weights, num_valid)
    write_ply(path, np.asarray(xyz[:num_valid], np.float32), colors=colors)


def save_dam_image_overlay(path: str, image: np.ndarray, saliency: np.ndarray) -> None:
    """A heat map of the image-side attribution over the RGB frame, as PNG
    (heat map + image, renormalized: `pytorch_dam/utils/image.py:81-104`)."""
    from imfnet_tpu_torch.geom.image import save_image

    img = np.asarray(image, np.float64)
    if img.max() > 1.0:
        img = img / 255.0
    s = np.asarray(saliency, np.float64)
    rng = s.max() - s.min()
    t = (s - s.min()) / (rng if rng > 0 else 1.0)
    heat = dam_colors(t.reshape(-1), t.size).reshape(*t.shape, 3)
    cam = heat + img
    cam = cam / cam.max()
    save_image(path, (cam * 255.0).astype(np.uint8))
