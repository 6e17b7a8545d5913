"""K3: fused full-canvas SDF layers.

Replaces the Pallas TPU kernel `smelter_tpu/ops/pallas/sdf_layers.py`
(`_layer_kernel_body`, launched at :131 by `_compose_call`). A run of L
colour, bordered-colour and box-shadow layers with animating geometry (no
static rect, no masks) OVER-blends onto an existing channel-major
premultiplied (4, H, W) f32 canvas. The CUDA kernel is
`smelter_tpu_torch/csrc/sdf_layers.cu` (layer math and tile classes in
`csrc/sdf_common.cuh`); it is bound by the canvas traffic of the tiles the
layers reach: a 32 x 32 tile where every layer is exactly 0 is neither read
nor written, and layers whose alpha is exactly 1 over a tile blend a flat
value there (`tile_class.py` is the plain mirror of that classifier).

Layer parameters are per-frame values; the layer kinds (content,
has_border, has_rotation) are fixed by the frame program's structure, so a
caller may keep their table (`kinds_table`) on the device.

`compose_sdf_layers_planar` launches the kernel for a CUDA canvas, which it
updates IN PLACE and returns; for a CPU canvas it returns the plain
version's new tensor. Either way the caller must use the returned tensor
and must not read the canvas it passed in again.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from smelter_tpu_torch.interop import upload
from smelter_tpu_torch.ops.compose import _over, _pixel_centers
from smelter_tpu_torch.ops.hopper import build
from smelter_tpu_torch.ops.hopper.scene_assembly import MemberSpec, _member_layer

PARAMS_WIDTH = 19  # 0:top 1:left 2:w 3:h 4:rot 5..8:radius 9..12:color
#                    13:border_width 14..17:border_color 18:blur
KIND_W = 3  # content (0 colour, 1 box shadow), has_border, has_rotation
_CONTENT = {"color": 0, "box_shadow": 1}

Kind = Tuple[str, bool, bool]

# kernel launches since the last reset (the main path's proof of use)
LAUNCHES = 0


def pack_layer_params(params_list) -> torch.Tensor:
    """LayoutParams -> (L, PARAMS_WIDTH) f32 rows on the params' device, in
    the column order of the reference's `pack_layer_params_traced`. (It
    differs from the frame program's packed vector, whose layout is
    `render/program.py:_P_FIXED`.)"""
    rows = [
        torch.cat([
            torch.stack([p.top, p.left, p.width, p.height, p.rotation_degrees]),
            p.border_radius.reshape(4),
            p.color.reshape(4),
            p.border_width.reshape(1),
            p.border_color.reshape(4),
            p.blur_radius.reshape(1),
        ]).to(torch.float32)
        for p in params_list
    ]
    return torch.stack(rows).contiguous()


def kinds_table(kinds: Sequence[Kind], device) -> torch.Tensor:
    """The (L, KIND_W) int32 table the kernel reads each layer's kind from."""
    rows = [[_CONTENT[c], int(b), int(r)] for c, b, r in kinds]
    return upload(torch.tensor(rows, dtype=torch.int32).reshape(-1, KIND_W), device)


def compose_sdf_layers_planar_plain(
    canvas: torch.Tensor, params: torch.Tensor, kinds: Sequence[Kind]
) -> torch.Tensor:
    """Plain PyTorch version of K3: each layer evaluated over the full canvas
    and OVER-blended, in paint order, in the operation order of
    `_layer_kernel_body` (which is K1's member math with no masks).
    Returns a new tensor."""
    _, h, w = canvas.shape
    px, py = _pixel_centers(0, 0, h, w, canvas.device)
    acc = canvas.to(torch.float32)
    for li, (content, has_border, has_rotation) in enumerate(kinds):
        spec = MemberSpec(content, has_border, has_rotation, 0, (), (0, 0, h, w))
        acc = _over(_member_layer(spec, params[li], px, py), acc)
    return acc


def _launch(canvas, params, kinds, table):
    global LAUNCHES
    n = len(kinds)
    if canvas.dtype != torch.float32 or canvas.dim() != 3 or canvas.shape[0] != 4:
        raise ValueError(f"K3 takes a (4, H, W) f32 canvas, got "
                         f"{tuple(canvas.shape)} {canvas.dtype}")
    if params.dtype != torch.float32 or tuple(params.shape) != (n, PARAMS_WIDTH):
        raise ValueError(f"K3 takes ({n}, {PARAMS_WIDTH}) f32 params, got "
                         f"{tuple(params.shape)} {params.dtype}")
    if table.dtype != torch.int32 or tuple(table.shape) != (n, KIND_W):
        raise ValueError(f"K3 takes a ({n}, {KIND_W}) int32 kinds table, got "
                         f"{tuple(table.shape)} {table.dtype}")
    if not (params.device == table.device == canvas.device):
        raise ValueError("K3 canvas, params and kinds table must share a device")
    if not (canvas.is_contiguous() and params.is_contiguous() and table.is_contiguous()):
        raise ValueError("K3 takes a contiguous canvas and tables")
    _, h, w = canvas.shape
    if h == 0 or w == 0:
        raise ValueError(f"K3 takes a non-empty canvas, got {w}x{h}")
    with torch.cuda.device(canvas.device):
        stream = torch.cuda.current_stream(canvas.device).cuda_stream
        err = build.library().smelter_sdf_layers(
            canvas.data_ptr(), params.data_ptr(), table.data_ptr(), n, h, w, stream,
        )
    build.check(err, "sdf_layers launch")
    LAUNCHES += 1
    return canvas


def compose_sdf_layers_planar(
    canvas: torch.Tensor,  # (4, H, W) premultiplied f32
    params: torch.Tensor,  # (L, PARAMS_WIDTH) f32
    kinds: Sequence[Kind],  # per layer: (content, has_border, has_rotation)
    table: Optional[torch.Tensor] = None,  # kinds_table(kinds), if built
) -> torch.Tensor:
    """Blend L layers over the canvas in one pass. Runs K3 on a CUDA canvas,
    in place (raising if it cannot launch), and the plain version on a CPU
    canvas. L = 0 returns the canvas untouched."""
    if not kinds:
        return canvas
    if canvas.device.type == "cpu":
        return compose_sdf_layers_planar_plain(canvas, params, kinds)
    if canvas.device.type != "cuda":
        raise ValueError(f"K3 runs on CUDA or CPU tensors, not {canvas.device}")
    if table is None:
        table = kinds_table(kinds, canvas.device)
    return _launch(canvas, params, kinds, table)
