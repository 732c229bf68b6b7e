"""Contrib operators: detection boxes, greedy NMS, MultiBox, ROI ops,
proposals, box coding, resizing, small ops and deformable convolution.

Counterpart of ``mxnet_tpu/ops/contrib.py`` (reference
``src/operator/contrib/``), with its names and aliases.  Every op is a
fixed-shape program of torch ops: a dynamic result count becomes
``-1``-padded (or zero-padded) slots, counts and sizes come from shapes,
and nothing reads a value back to the host, so a hybridized detector
captures into one CUDA graph.  Constants (anchor shapes, base anchors)
are made on the operand's device by fills (``_const``), never copied from
host memory, which a capture refuses.

The one sequential loop, greedy NMS (the reference's ``lax.fori_loop`` in
``_nms_keep``), runs on the card as the hand-written bitmask scan
``csrc/nms_keep.cu`` behind ``nms_keep`` (the pairs' suppression words,
then a warp an image walks them); its plain version
``_nms_keep_plain`` is a torch loop over the boxes, batched over images,
which only a CPU tensor takes.  The IoU of both follows ``_pair_iou``'s
operations in its order, in f32, so that the two give the same keep mask
bit for bit.  Sorts are stable (``stable=True``), as ``jnp.argsort`` is:
ties keep their index order, in the score order and in the compaction.

Where the reference's arithmetic runs in float64 (its tests enable
``jax_enable_x64``: ``jnp.arange(k) + 0.5`` is then float64), the port
computes in float32, what the reference computes without x64.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from .. import _kernels, cuda_graph
from ..base import MXNetError, resolve_dtype
from .nn_ops import _capturing, _tup
from .registry import apply_op, exporter
from .registry import make_exporter  # noqa: F401

__all__ = []
_export = exporter(__all__)

_F32 = torch.float32
_CONSTS = {}  # (values, device) -> f32 tensor made by fills


def _const(values, device):
    """A 1-d f32 tensor of the Python floats ``values`` on ``device``,
    written by one fill each (no host-to-device copy, which a CUDA graph
    capture refuses and which waits for the card's queue).  Kept for the
    next call, except one made while a stream captures: its fills run
    only when the graph replays."""
    key = (tuple(values), str(device))
    t = _CONSTS.get(key)
    if t is None:
        t = torch.empty(len(values), dtype=_F32, device=device)
        for i, v in enumerate(values):
            t[i].fill_(v)
        if not _capturing():
            _CONSTS[key] = t
    return t


def _argsort(x, dim=-1):
    """Stable ascending argsort (``jnp.argsort``'s order of ties)."""
    return torch.argsort(x, dim=dim, stable=True)


def _take_rows(x, idx):
    """``x`` (G, n, ...) gathered along dim 1 at ``idx`` (G, m)."""
    shape = idx.shape + x.shape[2:]
    view = idx.reshape(idx.shape + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, view.expand(shape))


# --- box geometry helpers ---------------------------------------------------

def _to_corner(b, fmt):
    """(..., 4) boxes → corner (x1, y1, x2, y2)."""
    if fmt == "corner":
        return b
    cx, cy, w, h = b.split(1, dim=-1)
    return torch.cat([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                     dim=-1)


def _from_corner(b, fmt):
    if fmt == "corner":
        return b
    x1, y1, x2, y2 = b.split(1, dim=-1)
    return torch.cat([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1],
                     dim=-1)


def _pair_iou(lhs, rhs):
    """IoU matrix: lhs (..., M, 4) corner × rhs (..., N, 4) corner →
    (..., M, N), the leading dims broadcast."""
    lx1, ly1, lx2, ly2 = [lhs[..., :, i, None] for i in range(4)]
    rx1, ry1, rx2, ry2 = [rhs[..., None, :, i] for i in range(4)]
    iw = torch.clamp(torch.minimum(lx2, rx2) - torch.maximum(lx1, rx1),
                     min=0.0)
    ih = torch.clamp(torch.minimum(ly2, ry2) - torch.maximum(ly1, ry1),
                     min=0.0)
    inter = iw * ih
    la = torch.clamp(lx2 - lx1, min=0.0) * torch.clamp(ly2 - ly1, min=0.0)
    ra = torch.clamp(rx2 - rx1, min=0.0) * torch.clamp(ry2 - ry1, min=0.0)
    union = la + ra - inter
    return torch.where(union > 0, inter / torch.clamp(union, min=1e-12),
                       0.0)


def box_iou(lhs, rhs, format="corner", **kwargs):
    """Reference ``_contrib_box_iou``: lhs (..., 4) × rhs (..., 4) →
    IoU of every lhs box against every rhs box."""

    def _f(l, r):
        lsh, rsh = l.shape[:-1], r.shape[:-1]
        out = _pair_iou(_to_corner(l.reshape(-1, 4), format),
                        _to_corner(r.reshape(-1, 4), format))
        return out.reshape(lsh + rsh)

    return apply_op(_f, lhs, rhs, name="box_iou")


_export(box_iou, aliases=("_contrib_box_iou",))


# --- greedy NMS: the kernel and its plain version ---------------------------

_PLAIN_CHUNK = 1 << 24  # elements of one block of rows of the plain IoU


def _nms_keep_plain(boxes, valid, cls, overlap_thresh):
    """Plain version of ``nms_keep``: the reference's loop
    ``keep & ~(sup_mat[i] & keep[i])`` over i, batched over the G images,
    with ``sup_mat`` made a block of rows at a time (so that n = 10,000
    and more fit in memory)."""
    g, n = valid.shape
    keep = valid.clone()
    cols = torch.arange(n, device=boxes.device)
    rows = max(1, _PLAIN_CHUNK // max(1, g * n))
    for i0 in range(0, n, rows):
        i1 = min(n, i0 + rows)
        sup = _pair_iou(boxes[:, i0:i1], boxes) > overlap_thresh
        sup &= cols[None, None, :] > cols[i0:i1, None][None]
        if cls is not None:
            sup &= cls[:, i0:i1, None] == cls[:, None, :]
        for i in range(i0, i1):
            keep = keep & ~(sup[:, i - i0] & keep[:, i:i + 1])
    return keep


#: bytes of scratch (suppression words, their summaries, the removed
#  masks) one chunk of images of the scan may hold, unless one image's
#  alone passes it
_NMS_SCRATCH_CAP = 64 << 20


def _nms_image_words(n):
    """64-bit words of scratch an image of ``n`` boxes takes: n rows of
    suppression words and of their summary, then its removed mask."""
    nw = -(-n // 64)
    return n * (nw + -(-nw // 64)) + nw


def _nms_plan(g, n):
    """Images a chunk of the scan (two launches and a memset each): as
    many as keep the chunk's scratch within ``_NMS_SCRATCH_CAP``, at
    least one (an image whose scratch alone passes the cap is a chunk of
    its own, so no n is refused)."""
    fit = _NMS_SCRATCH_CAP // (8 * _nms_image_words(n))
    return max(1, min(g, 65535, fit))


def nms_keep(boxes, valid, cls, overlap_thresh):
    """Greedy NMS over boxes sorted by descending score: boxes (G, n, 4)
    f32 corners, valid (G, n) bool, cls (G, n) f32 class ids or None
    (suppress across classes) → the keep mask (G, n) bool.  A box is kept
    when it is valid and no kept box before it overlaps it by more than
    ``overlap_thresh`` (of the same class, when ``cls`` is given).

    The custom op ``mxnet_tpu_torch::nms_keep``, so an exported program
    (``HybridBlock.export``) holds it as one node.  A CUDA tensor
    launches ``csrc/nms_keep.cu``, a bitmask scan: the 64-bit
    suppression words of every pair block on or above the diagonal, then
    a warp an image walks them in word order, two kernels for each chunk
    of images (``_nms_plan``).  ``nms_keep.launches`` counts the calls,
    ``nms_keep.cuda_launches`` the kernels they launched.  CPU tensors
    take the plain version."""
    return _nms_keep_op(boxes, valid, cls, float(overlap_thresh))


@torch.library.custom_op("mxnet_tpu_torch::nms_keep", mutates_args=(),
                         device_types="cpu")
def _nms_keep_op(boxes: torch.Tensor, valid: torch.Tensor,
                 cls: torch.Tensor | None,
                 overlap_thresh: float) -> torch.Tensor:
    """The op's CPU implementation: the plain version."""
    return _nms_keep_plain(boxes, valid, cls, overlap_thresh)


@_nms_keep_op.register_kernel("cuda")
def _nms_keep_cuda(boxes, valid, cls, overlap_thresh):
    """The op's CUDA implementation: the scan's two kernels a chunk of
    images, through its C entry point on the current stream."""
    g, n = valid.shape
    if boxes.dtype != _F32 or tuple(boxes.shape) != (g, n, 4) or \
            valid.dtype != torch.bool or valid.device != boxes.device or \
            (cls is not None and (
                cls.dtype != _F32 or tuple(cls.shape) != (g, n) or
                cls.device != boxes.device)):
        raise MXNetError(
            "nms_keep: expected boxes (G, n, 4) float32, valid (G, n) bool "
            "and cls (G, n) float32 or None on one CUDA device; got "
            f"{boxes.dtype} {tuple(boxes.shape)} on {boxes.device}, "
            f"{valid.dtype} {tuple(valid.shape)} on {valid.device}, "
            f"{None if cls is None else (cls.dtype, tuple(cls.shape))}")
    keep = torch.empty((g, n), dtype=torch.uint8, device=boxes.device)
    if g * n == 0:
        return keep.view(torch.bool)
    boxes = boxes.contiguous()
    if boxes.data_ptr() % 16:  # the kernel reads a box as one float4
        boxes = boxes.clone()
    flags = valid.contiguous().view(torch.uint8)
    ids = None if cls is None else cls.contiguous()
    chunk = _nms_plan(g, n)
    scratch = torch.empty(chunk * _nms_image_words(n), dtype=torch.int64,
                          device=boxes.device)
    launched = ctypes.c_int(0)
    lib = _kernels.load("nms_keep")
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream(boxes.device).cuda_stream
        err = lib.mxt_nms_keep(boxes.data_ptr(), flags.data_ptr(),
                               None if ids is None else ids.data_ptr(),
                               keep.data_ptr(), scratch.data_ptr(), g, n,
                               float(overlap_thresh), chunk,
                               ctypes.addressof(launched), stream)
    _kernels.check(lib, err, "nms_keep launch")
    cuda_graph.count(nms_keep)
    cuda_graph.count(nms_keep, "cuda_launches", launched.value)
    return keep.view(torch.bool)


@_nms_keep_op.register_fake
def _nms_keep_fake(boxes, valid, cls, overlap_thresh):
    """The op's output under a trace: the (G, n) bool keep mask."""
    return valid.new_empty(valid.shape, dtype=torch.bool)


nms_keep.launches = 0
nms_keep.cuda_launches = 0


def _nms_scan(boxes, valid, cls, overlap_thresh, topk=-1):
    """``nms_keep`` restricted to the first ``topk`` sorted boxes when
    ``topk > 0``: the reference invalidates every box past ``topk``
    (``vs &= arange(n) < topk``), and an invalid box is never kept and
    never suppresses, so scanning only ``min(n, topk)`` boxes gives the
    same mask (YOLOv3's 10,647 boxes an image scan as 400)."""
    n = valid.shape[1]
    m = min(n, topk) if topk > 0 else n
    boxes = boxes.to(_F32)
    cls = None if cls is None else cls.to(_F32)
    if m == n:
        return nms_keep(boxes, valid, cls, overlap_thresh)
    head = nms_keep(boxes[:, :m].contiguous(), valid[:, :m].contiguous(),
                    None if cls is None else cls[:, :m].contiguous(),
                    overlap_thresh)
    return torch.cat([head, torch.zeros_like(valid[:, m:])], dim=1)


def box_nms(data, overlap_thresh=0.5, valid_thresh=0, topk=-1,
            coord_start=2, score_index=1, id_index=-1, background_id=-1,
            force_suppress=False, in_format="corner", out_format="corner",
            **kwargs):
    """Reference ``_contrib_box_nms`` (``bounding_box.cc``): greedy NMS.

    data (..., N, K): suppressed/invalid slots become all -1; survivors are
    compacted to the front in descending-score order (reference contract).
    The overlaps are computed on f32 corners (a bf16 input's rows keep
    their dtype)."""

    def _f(d):
        flat = d.reshape((-1,) + tuple(d.shape[-2:]))
        n = flat.shape[1]
        scores = flat[..., score_index]
        cls = flat[..., id_index] if id_index >= 0 else None
        valid = scores > valid_thresh
        if id_index >= 0 and background_id >= 0:
            valid &= cls != background_id
        order = _argsort(torch.where(valid, -scores, math.inf))
        ds = _take_rows(flat, order)
        vs = torch.gather(valid, 1, order)
        if topk > 0:
            vs &= torch.arange(n, device=d.device) < topk
        boxes = _to_corner(ds[..., coord_start:coord_start + 4], in_format)
        same = None if (force_suppress or id_index < 0) else \
            torch.gather(cls, 1, order)
        keep = _nms_scan(boxes, vs, same, overlap_thresh, topk)
        out = ds
        if out_format != in_format:
            conv = _from_corner(boxes, out_format)
            out = torch.cat([ds[..., :coord_start], conv,
                             ds[..., coord_start + 4:]], dim=-1)
        out = torch.where(keep[..., None], out, -torch.ones_like(out))
        # compact survivors to the front (stable: preserves score order)
        comp = _argsort((~keep).to(torch.uint8))
        return _take_rows(out, comp).reshape(d.shape)

    return apply_op(_f, data, name="box_nms")


_export(box_nms, aliases=("_contrib_box_nms", "box_non_maximum_suppression"))


def bipartite_matching(data, threshold=0.5, is_ascend=False, topk=-1,
                       **kwargs):
    """Reference ``_contrib_bipartite_matching``: greedy bipartite matching
    on a (..., M, N) weight matrix.  Returns (row→col matches (..., M),
    col→row matches (..., N)) as float32, -1 for unmatched."""

    def _f(w):
        lead, (m, n) = w.shape[:-2], w.shape[-2:]
        sign = 1.0 if is_ascend else -1.0
        wm = w.reshape(-1, m, n)
        g = wm.shape[0]
        rows = torch.arange(m, device=w.device)
        cols = torch.arange(n, device=w.device)
        rmatch = torch.full((g, m), -1.0, dtype=_F32, device=w.device)
        cmatch = torch.full((g, n), -1.0, dtype=_F32, device=w.device)
        for _ in range(min(m, n) if topk <= 0 else min(topk, m, n)):
            idx = torch.argmin(sign * wm.reshape(g, -1), dim=1)
            i, j = idx // n, idx % n
            val = torch.gather(wm.reshape(g, -1), 1, idx[:, None])[:, 0]
            ok = (val < threshold) if is_ascend else (val >= threshold)
            rsel = (rows[None] == i[:, None]) & ok[:, None]
            csel = (cols[None] == j[:, None]) & ok[:, None]
            rmatch = torch.where(rsel, j[:, None].to(_F32), rmatch)
            cmatch = torch.where(csel, i[:, None].to(_F32), cmatch)
            wm = torch.where(rsel[:, :, None] | csel[:, None, :],
                             sign * math.inf, wm)
        return rmatch.reshape(lead + (m,)), cmatch.reshape(lead + (n,))

    return apply_op(_f, data, name="bipartite_matching", no_grad=True)


_export(bipartite_matching, aliases=("_contrib_bipartite_matching",))


# --- MultiBox (SSD) family --------------------------------------------------

def multibox_prior(data, sizes=(1.0,), ratios=(1.0,), clip=False,
                   steps=(-1.0, -1.0), offsets=(0.5, 0.5), **kwargs):
    """Reference ``_contrib_MultiBoxPrior`` (``multibox_prior.cc``):
    anchor boxes for feature map data (B, C, H, W) → (1, H*W*A, 4)
    normalized corner boxes, A = len(sizes) + len(ratios) - 1.  The
    anchors are made on data's device from ``arange`` and fills."""
    sizes = [float(s) for s in np.atleast_1d(sizes)]
    ratios = [float(r) for r in np.atleast_1d(ratios)]

    def _f(d):
        h, w = d.shape[2], d.shape[3]
        step_y = steps[0] if steps[0] > 0 else 1.0 / h
        step_x = steps[1] if steps[1] > 0 else 1.0 / w
        cy = (torch.arange(h, dtype=_F32, device=d.device) + offsets[0]) \
            * step_y
        cx = (torch.arange(w, dtype=_F32, device=d.device) + offsets[1]) \
            * step_x
        # anchor shapes: (size_k, ratios[0]) for all k, then (sizes[0],
        # ratio_j) for j >= 1 — reference enumeration order
        ws, hs = [], []
        for s in sizes:
            r = np.sqrt(ratios[0])
            ws.append(s * r * h / w / 2)
            hs.append(s / r / 2)
        for r in ratios[1:]:
            rr = np.sqrt(r)
            ws.append(sizes[0] * rr * h / w / 2)
            hs.append(sizes[0] / rr / 2)
        whs = _const([float(np.float32(v)) for v in ws + hs], d.device)
        ws, hs = whs[:len(ws)], whs[len(ws):]
        cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")  # (H, W)
        cxg = cxg[..., None]
        cyg = cyg[..., None]
        out = torch.stack([cxg - ws, cyg - hs, cxg + ws, cyg + hs],
                          dim=-1)  # (H, W, A, 4)
        out = out.reshape(1, -1, 4)
        return torch.clamp(out, 0.0, 1.0) if clip else out

    return apply_op(_f, data, name="multibox_prior", no_grad=True)


_export(multibox_prior,
        aliases=("MultiBoxPrior", "_contrib_MultiBoxPrior"))


def multibox_target(anchor, label, cls_pred, overlap_threshold=0.5,
                    ignore_label=-1.0, negative_mining_ratio=-1.0,
                    negative_mining_thresh=0.5, minimum_negative_samples=0,
                    variances=(0.1, 0.1, 0.2, 0.2), **kwargs):
    """Reference ``_contrib_MultiBoxTarget`` (``multibox_target.cc``):
    anchor (1, N, 4), label (B, M, 5) [cls x1 y1 x2 y2, -1 padded],
    cls_pred (B, num_cls+1, N) → (loc_target (B, N*4), loc_mask (B, N*4),
    cls_target (B, N)).  The labels are not checked (nothing is read on
    the host), as in the reference."""
    var = [float(v) for v in np.asarray(variances, np.float32)]

    def _f(anc, lab, cp):
        a = anc[0].to(_F32)
        lab = lab.to(_F32)
        b, m = lab.shape[0], lab.shape[1]
        n = a.shape[0]
        gt_valid = lab[..., 0] >= 0
        iou = _pair_iou(a[None], lab[..., 1:5])  # (B, N, M)
        iou = torch.where(gt_valid[:, None, :], iou, -1.0)
        # stage 1: each gt greedily claims its best anchor (bipartite)
        anchors_ix = torch.arange(n, device=a.device)
        gts_ix = torch.arange(m, device=a.device)
        mat = iou
        matched = torch.full((b, n), -1, dtype=torch.int64, device=a.device)
        for _ in range(m):
            idx = torch.argmax(mat.reshape(b, -1), dim=1)
            ai, gi = idx // m, idx % m
            val = torch.gather(mat.reshape(b, -1), 1, idx[:, None])[:, 0]
            ok = val > 1e-12
            rsel = (anchors_ix[None] == ai[:, None]) & ok[:, None]
            csel = (gts_ix[None] == gi[:, None]) & ok[:, None]
            matched = torch.where(rsel, gi[:, None], matched)
            mat = torch.where(rsel[:, :, None] | csel[:, None, :], -1.0,
                              mat)
        # stage 2: remaining anchors match best gt if IoU >= threshold
        best_iou = iou.amax(dim=2)
        best_gt = torch.argmax(iou, dim=2)
        matched = torch.where((matched < 0) & (best_iou >= overlap_threshold),
                              best_gt, matched)
        pos = matched >= 0
        mi = torch.clamp(matched, min=0)
        g = _take_rows(lab[..., 1:5], mi)  # (B, N, 4)
        # encode center-form offsets
        ax, ay = (a[:, 0] + a[:, 2]) / 2, (a[:, 1] + a[:, 3]) / 2
        aw = torch.clamp(a[:, 2] - a[:, 0], min=1e-12)
        ah = torch.clamp(a[:, 3] - a[:, 1], min=1e-12)
        gx, gy = (g[..., 0] + g[..., 2]) / 2, (g[..., 1] + g[..., 3]) / 2
        gw = torch.clamp(g[..., 2] - g[..., 0], min=1e-12)
        gh = torch.clamp(g[..., 3] - g[..., 1], min=1e-12)
        loc = torch.stack([(gx - ax) / aw / var[0], (gy - ay) / ah / var[1],
                           torch.log(gw / aw) / var[2],
                           torch.log(gh / ah) / var[3]], dim=-1)
        loc = torch.where(pos[..., None], loc, 0.0).reshape(b, -1)
        mask = pos[..., None].expand(b, n, 4).to(_F32).reshape(b, -1)
        cls_t = torch.where(pos, torch.gather(lab[..., 0], 1, mi) + 1.0,
                            0.0)
        if negative_mining_ratio > 0:
            # rank negatives by background-class confidence deficit
            bg_prob = torch.softmax(cp.to(_F32), dim=1)[:, 0]  # (B, N)
            neg_score = torch.where(
                pos | (best_iou >= negative_mining_thresh), math.inf,
                bg_prob)
            num_pos = pos.sum(dim=1, keepdim=True).to(_F32)
            quota = torch.clamp(num_pos * negative_mining_ratio,
                                min=float(minimum_negative_samples))
            rank = _argsort(_argsort(neg_score))
            keep_neg = rank < quota
            cls_t = torch.where(pos, cls_t, torch.where(
                keep_neg, 0.0, float(ignore_label)))
        return loc, mask, cls_t

    return apply_op(_f, anchor, label, cls_pred, name="multibox_target",
                    no_grad=True)


_export(multibox_target,
        aliases=("MultiBoxTarget", "_contrib_MultiBoxTarget"))


def multibox_detection(cls_prob, loc_pred, anchor, clip=True, threshold=0.01,
                       background_id=0, nms_threshold=0.5,
                       force_suppress=False,
                       variances=(0.1, 0.1, 0.2, 0.2), nms_topk=-1,
                       **kwargs):
    """Reference ``_contrib_MultiBoxDetection`` (``multibox_detection.cc``):
    cls_prob (B, num_cls+1, N), loc_pred (B, N*4), anchor (1, N, 4) →
    (B, N, 6) rows [cls_id, score, x1, y1, x2, y2], -1 for invalid."""
    var = [float(v) for v in np.asarray(variances, np.float32)]

    def _f(cp, lp, anc):
        anc = anc[0]
        n = anc.shape[0]
        # the reference's f32 variances promote a bf16 lp to f32
        lp = lp.reshape(lp.shape[0], n, 4).to(
            torch.promote_types(lp.dtype, _F32))
        ax, ay = (anc[:, 0] + anc[:, 2]) / 2, (anc[:, 1] + anc[:, 3]) / 2
        aw = anc[:, 2] - anc[:, 0]
        ah = anc[:, 3] - anc[:, 1]
        cx = lp[..., 0] * var[0] * aw + ax
        cy = lp[..., 1] * var[1] * ah + ay
        w = torch.exp(lp[..., 2] * var[2]) * aw / 2
        h = torch.exp(lp[..., 3] * var[3]) * ah / 2
        boxes = torch.stack([cx - w, cy - h, cx + w, cy + h], dim=-1)
        if clip:
            boxes = torch.clamp(boxes, 0.0, 1.0)
        # best foreground class per anchor (reference picks argmax != bg)
        fg = torch.cat([cp[:, :background_id], cp[:, background_id + 1:]],
                       dim=1)
        score = fg.amax(dim=1)
        cls_id = torch.argmax(fg, dim=1).to(_F32)
        keep = score > threshold
        dt = torch.promote_types(score.dtype, boxes.dtype)
        return torch.cat(
            [torch.where(keep, cls_id, -1.0)[..., None].to(dt),
             torch.where(keep, score, -1.0)[..., None].to(dt),
             torch.where(keep[..., None], boxes, -1.0).to(dt)], dim=-1)

    dets = apply_op(_f, cls_prob, loc_pred, anchor,
                    name="multibox_detection")
    return box_nms(dets, overlap_thresh=nms_threshold, valid_thresh=0.0,
                   topk=nms_topk, coord_start=2, score_index=1, id_index=0,
                   force_suppress=force_suppress)


_export(multibox_detection,
        aliases=("MultiBoxDetection", "_contrib_MultiBoxDetection"))


# --- ROI ops ----------------------------------------------------------------

def _bilinear(feat, bidx, ys, xs):
    """feat (B, C, H, W); bidx (R,) image of each row; ys/xs (R, P)
    fractional coords → (R, C, P).  Out-of-range samples contribute 0 per
    corner (reference ROIAlign zero-padding contract, not a clamp to the
    edge).  The four corners are gathered from a (B·H·W, C) copy of the
    map with ``index_select``, whose gradient is an ``index_add_``."""
    b, c, h, w = feat.shape
    r, p = ys.shape
    flat = feat.permute(0, 2, 3, 1).reshape(b * h * w, c)
    base = bidx.to(torch.int64)[:, None] * (h * w)
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy1 = ys - y0
    wx1 = xs - x0
    out = 0.0
    for dy, wy in ((0, 1.0 - wy1), (1, wy1)):
        for dx, wx in ((0, 1.0 - wx1), (1, wx1)):
            yy = y0.to(torch.int32) + dy
            xx = x0.to(torch.int32) + dx
            inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            idx = base + torch.clamp(yy, 0, h - 1).to(torch.int64) * w + \
                torch.clamp(xx, 0, w - 1).to(torch.int64)
            v = flat.index_select(0, idx.reshape(-1)).reshape(r, p, c)
            out = out + v * (wy * wx * inside)[..., None]
    return out.permute(0, 2, 1)


def roi_align(data, rois, pooled_size, spatial_scale=1.0, sample_ratio=-1,
              position_sensitive=False, aligned=False, **kwargs):
    """Reference ``_contrib_ROIAlign`` (``roi_align.cc``): data
    (B, C, H, W), rois (R, 5) [batch_idx x1 y1 x2 y2] → (R, C, PH, PW).
    Average of bilinear samples per bin (Mask-RCNN ROIAlign); 2 samples a
    side of a bin when ``sample_ratio <= 0`` (no adaptive count); the
    image index is ``roi[0]`` cast to int (truncated)."""
    ph, pw = ((pooled_size, pooled_size) if isinstance(pooled_size, int)
              else tuple(pooled_size))
    sr = sample_ratio if sample_ratio > 0 else 2

    def _f(d, r):
        dev = d.device
        b = r[:, 0].to(torch.int32)
        off = 0.5 if aligned else 0.0
        x1 = r[:, 1] * spatial_scale - off
        y1 = r[:, 2] * spatial_scale - off
        x2 = r[:, 3] * spatial_scale - off
        y2 = r[:, 4] * spatial_scale - off
        rw = torch.clamp(x2 - x1, min=1.0 if not aligned else 1e-6)
        rh = torch.clamp(y2 - y1, min=1.0 if not aligned else 1e-6)
        bh, bw = rh / ph, rw / pw
        # sample grid: for bin (i,j), samples at y1 + (i + (k+.5)/sr)*bh
        sub = (torch.arange(sr, dtype=_F32, device=dev)[None, :] + 0.5) / sr
        gy = y1[:, None] + (torch.arange(ph, dtype=_F32, device=dev)[:, None]
                            + sub).reshape(-1)[None] * bh[:, None]
        gx = x1[:, None] + (torch.arange(pw, dtype=_F32, device=dev)[:, None]
                            + sub).reshape(-1)[None] * bw[:, None]
        nr = r.shape[0]
        yy = gy[:, :, None].expand(nr, ph * sr, pw * sr)
        xx = gx[:, None, :].expand(nr, ph * sr, pw * sr)
        vals = _bilinear(d, b, yy.reshape(nr, -1), xx.reshape(nr, -1))
        c = d.shape[1]
        return vals.reshape(nr, c, ph, sr, pw, sr).mean(dim=(3, 5))

    return apply_op(_f, data, rois, name="roi_align")


_export(roi_align, aliases=("ROIAlign", "_contrib_ROIAlign"))


def roi_pooling(data, rois, pooled_size, spatial_scale=1.0, **kwargs):
    """Reference legacy ``ROIPooling`` (``src/operator/roi_pooling.cc``):
    max-pool quantized ROI bins.  data (B, C, H, W), rois (R, 5) →
    (R, C, PH, PW)."""
    ph, pw = ((pooled_size, pooled_size) if isinstance(pooled_size, int)
              else tuple(pooled_size))

    def _f(d, r):
        dev = d.device
        img = d[r[:, 0].to(torch.int64)]  # (R, C, H, W)
        h, w = img.shape[2], img.shape[3]
        x1 = torch.round(r[:, 1] * spatial_scale)[:, None]
        y1 = torch.round(r[:, 2] * spatial_scale)[:, None]
        x2 = torch.round(r[:, 3] * spatial_scale)[:, None]
        y2 = torch.round(r[:, 4] * spatial_scale)[:, None]
        rh = torch.clamp(y2 - y1 + 1, min=1.0)
        rw = torch.clamp(x2 - x1 + 1, min=1.0)
        ys = torch.arange(h, dtype=_F32, device=dev)
        xs = torch.arange(w, dtype=_F32, device=dev)
        i = torch.arange(ph, dtype=_F32, device=dev)[None, :]
        j = torch.arange(pw, dtype=_F32, device=dev)[None, :]
        hstart = (torch.floor(i * rh / ph) + y1)[..., None]
        hend = (torch.ceil((i + 1) * rh / ph) + y1)[..., None]
        wstart = (torch.floor(j * rw / pw) + x1)[..., None]
        wend = (torch.ceil((j + 1) * rw / pw) + x1)[..., None]
        my = (ys >= hstart) & (ys < hend)  # (R, PH, H)
        mx = (xs >= wstart) & (xs < wend)  # (R, PW, W)
        neg = torch.finfo(img.dtype).min
        t = torch.where(my[:, None, :, :, None], img[:, :, None], neg)
        t = t.amax(dim=3)  # (R, C, PH, W)
        t = torch.where(mx[:, None, None, :, :], t[:, :, :, None, :], neg)
        out = t.amax(dim=4)  # (R, C, PH, PW)
        return torch.where(out == neg, 0.0, out)

    return apply_op(_f, data, rois, name="roi_pooling")


_export(roi_pooling, aliases=("ROIPooling",))


def _base_anchors(scales, ratios, base):
    """Faster R-CNN's base anchors (A, 4) as Python floats, centered on
    (stride-1)/2 — standard RPN enumeration."""
    out = []
    cx = cy = (base - 1) / 2
    for r in ratios:
        size = base * base
        ws = np.round(np.sqrt(size / r))
        hs = np.round(ws * r)
        for s in scales:
            w, h = ws * s, hs * s
            out += [float(np.float32(v)) for v in (
                cx - (w - 1) / 2, cy - (h - 1) / 2, cx + (w - 1) / 2,
                cy + (h - 1) / 2)]
    return out


def _proposal_images(cp, bp, info, banchors, base, a, pre_n, post_n,
                     threshold, min_size):
    """RPN proposals of every image of the batch (the reference's
    ``_proposal_image``, batched): → boxes (B, post_n, 4), scores
    (B, post_n), zero rows past the survivors."""
    bsz, h, w = cp.shape[0], cp.shape[2], cp.shape[3]
    dev = cp.device
    shift_x = torch.arange(w, dtype=_F32, device=dev) * base
    shift_y = torch.arange(h, dtype=_F32, device=dev) * base
    sy, sx = torch.meshgrid(shift_y, shift_x, indexing="ij")
    shifts = torch.stack([sx, sy, sx, sy], dim=-1)  # (H, W, 4)
    anchors = (shifts[:, :, None, :] + banchors[None, None]
               ).reshape(-1, 4)  # (H*W*A, 4)
    scores = cp[:, a:].permute(0, 2, 3, 1).reshape(bsz, -1)  # fg scores
    deltas = bp.permute(0, 2, 3, 1).reshape(bsz, -1, 4)
    ax = (anchors[:, 0] + anchors[:, 2]) / 2
    ay = (anchors[:, 1] + anchors[:, 3]) / 2
    aw = anchors[:, 2] - anchors[:, 0] + 1
    ah = anchors[:, 3] - anchors[:, 1] + 1
    cx_ = deltas[..., 0] * aw + ax
    cy_ = deltas[..., 1] * ah + ay
    pw_ = torch.exp(torch.clamp(deltas[..., 2], -10, 10)) * aw
    ph_ = torch.exp(torch.clamp(deltas[..., 3], -10, 10)) * ah
    zero = torch.zeros_like(info[:, :1])
    xmax, ymax = info[:, 1:2] - 1, info[:, 0:1] - 1
    x1 = torch.clamp(cx_ - (pw_ - 1) / 2, zero, xmax)
    y1 = torch.clamp(cy_ - (ph_ - 1) / 2, zero, ymax)
    x2 = torch.clamp(cx_ + (pw_ - 1) / 2, zero, xmax)
    y2 = torch.clamp(cy_ + (ph_ - 1) / 2, zero, ymax)
    msz = min_size * info[:, 2:3]
    valid = (x2 - x1 + 1 >= msz) & (y2 - y1 + 1 >= msz)
    n = scores.shape[1]
    pre = min(pre_n, n) if pre_n > 0 else n
    order = _argsort(torch.where(valid, -scores, math.inf))[:, :pre]
    boxes = _take_rows(torch.stack([x1, y1, x2, y2], dim=-1), order)
    sc = torch.gather(scores, 1, order)
    vs = torch.gather(valid, 1, order)
    keep = nms_keep(boxes.to(_F32).contiguous(), vs.contiguous(), None,
                    threshold)
    comp = _argsort((~keep).to(torch.uint8))[:, :post_n]
    kc = torch.gather(keep, 1, comp)
    out_boxes = torch.where(kc[..., None], _take_rows(boxes, comp), 0.0)
    out_sc = torch.where(kc, torch.gather(sc, 1, comp), 0.0)
    # fixed-shape contract: always exactly post_n rows per image
    deficit = post_n - out_boxes.shape[1]
    if deficit > 0:
        out_boxes = torch.cat([out_boxes, out_boxes.new_zeros(
            (bsz, deficit, 4))], dim=1)
        out_sc = torch.cat([out_sc, out_sc.new_zeros((bsz, deficit))],
                           dim=1)
    return out_boxes, out_sc


def proposal(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n=6000,
             rpn_post_nms_top_n=300, threshold=0.7, rpn_min_size=16,
             scales=(4, 8, 16, 32), ratios=(0.5, 1, 2), feature_stride=16,
             output_score=False, iou_loss=False, **kwargs):
    """Reference ``_contrib_Proposal`` (``proposal.cc``): RPN proposal
    generation.  cls_prob (B, 2A, H, W), bbox_pred (B, 4A, H, W),
    im_info (B, 3) [h, w, scale] → rois (B*post_n, 5) [batch_idx x1 y1 x2
    y2] (+ scores (B*post_n, 1) when output_score).  The "+1" pixel
    convention, deltas clipped to ±10 before ``exp``, and zero rows (not
    -1) past the survivors."""
    scales = [float(s) for s in np.atleast_1d(scales)]
    ratios = [float(r) for r in np.atleast_1d(ratios)]
    a = len(scales) * len(ratios)
    base = float(feature_stride)
    flat_anchors = _base_anchors(scales, ratios, base)

    def _f(cp, bp, info):
        banchors = _const(flat_anchors, cp.device).reshape(a, 4)
        boxes, sc = _proposal_images(
            cp, bp, info, banchors, base, a, rpn_pre_nms_top_n,
            rpn_post_nms_top_n, threshold, rpn_min_size)
        b = cp.shape[0]
        bidx = torch.arange(b, dtype=boxes.dtype, device=cp.device) \
            .repeat_interleave(boxes.shape[1])[:, None]
        rois = torch.cat([bidx, boxes.reshape(-1, 4)], dim=-1)
        if output_score:
            return rois, sc.reshape(-1, 1)
        return rois

    return apply_op(_f, cls_prob, bbox_pred, im_info, name="proposal")


_export(proposal, aliases=("Proposal", "_contrib_Proposal"))


def box_decode(data, anchors, std0=1.0, std1=1.0, std2=1.0, std3=1.0,
               clip=-1.0, format="center", **kwargs):
    """Reference ``_contrib_box_decode``: decode (B, N, 4) deltas with
    (1, N, 4) center-format anchors → corner boxes."""

    def _f(d, anc):
        if format == "corner":
            anc = _from_corner(anc, "center")
        ax, ay, aw, ah = [anc[..., i] for i in range(4)]
        cx = d[..., 0] * std0 * aw + ax
        cy = d[..., 1] * std1 * ah + ay
        dw = d[..., 2] * std2
        dh = d[..., 3] * std3
        if clip > 0:
            dw = torch.clamp(dw, max=clip)
            dh = torch.clamp(dh, max=clip)
        w = torch.exp(dw) * aw / 2
        h = torch.exp(dh) * ah / 2
        return torch.stack([cx - w, cy - h, cx + w, cy + h], dim=-1)

    return apply_op(_f, data, anchors, name="box_decode")


_export(box_decode, aliases=("_contrib_box_decode",))


def box_encode(samples, matches, anchors, refs, means=(0., 0., 0., 0.),
               stds=(0.1, 0.1, 0.2, 0.2), **kwargs):
    """Reference ``_contrib_box_encode``: encode matched gt boxes against
    anchors → (targets (B, N, 4), masks (B, N, 4))."""
    mn = [float(v) for v in np.asarray(means, np.float32)]
    sd = [float(v) for v in np.asarray(stds, np.float32)]

    def _f(s, m, anc, ref):
        g = _take_rows(ref, torch.clamp(m, min=0).to(torch.int64))
        ac = _from_corner(anc, "center")
        gc = _from_corner(g, "center")
        t = torch.stack([
            (gc[..., 0] - ac[..., 0]) / torch.clamp(ac[..., 2], min=1e-12),
            (gc[..., 1] - ac[..., 1]) / torch.clamp(ac[..., 3], min=1e-12),
            torch.log(torch.clamp(gc[..., 2], min=1e-12)
                      / torch.clamp(ac[..., 2], min=1e-12)),
            torch.log(torch.clamp(gc[..., 3], min=1e-12)
                      / torch.clamp(ac[..., 3], min=1e-12))], dim=-1)
        t = torch.stack([(t[..., i] - mn[i]) / sd[i] for i in range(4)],
                        dim=-1)
        mask = ((s > 0.5) & (m >= 0))[..., None].expand(t.shape).to(t.dtype)
        return torch.where(mask > 0, t, 0.0), mask

    return apply_op(_f, samples, matches, anchors, refs, name="box_encode")


_export(box_encode, aliases=("_contrib_box_encode",))


# --- resize / adaptive pooling ---------------------------------------------

def bilinear_resize_2d(data, height=None, width=None, scale_height=None,
                       scale_width=None, mode="size", **kwargs):
    """Reference ``_contrib_BilinearResize2D`` (``bilinear_resize.cc``):
    NCHW bilinear resize, align_corners=True semantics (reference uses the
    PyTorch-1.x-era convention)."""

    def _f(d):
        b, h, w = d.shape[0], d.shape[2], d.shape[3]
        oh = int(height) if height else int(round(h * (scale_height or 1)))
        ow = int(width) if width else int(round(w * (scale_width or 1)))
        ys = (torch.arange(oh, dtype=_F32, device=d.device)
              * ((h - 1) / max(oh - 1, 1)))
        xs = (torch.arange(ow, dtype=_F32, device=d.device)
              * ((w - 1) / max(ow - 1, 1)))
        yy, xx = torch.meshgrid(ys, xs, indexing="ij")
        vals = _bilinear(d, torch.arange(b, device=d.device),
                         yy.reshape(1, -1).expand(b, -1),
                         xx.reshape(1, -1).expand(b, -1))
        return vals.reshape(b, -1, oh, ow)

    return apply_op(_f, data, name="bilinear_resize_2d")


_export(bilinear_resize_2d,
        aliases=("BilinearResize2D", "_contrib_BilinearResize2D"))


def _avg_mat(n_in, n_out, device):
    """(n_out, n_in) averaging matrix of adaptive pooling, made on the
    device from the bins' Python-int bounds."""
    starts = [float(math.floor(i * n_in / n_out)) for i in range(n_out)]
    ends = [float(math.ceil((i + 1) * n_in / n_out)) for i in range(n_out)]
    se = _const(starts + ends, device)
    s, e = se[:n_out, None], se[n_out:, None]
    j = torch.arange(n_in, dtype=_F32, device=device)[None]
    return ((j >= s) & (j < e)).to(_F32) * (1.0 / (e - s))


def adaptive_avg_pooling_2d(data, output_size=1, **kwargs):
    """Reference ``_contrib_AdaptiveAvgPooling2D``: NCHW adaptive average
    pool, as two small products with averaging matrices."""
    osz = ((output_size, output_size) if isinstance(output_size, int)
           else tuple(output_size))

    def _f(d):
        h, w = d.shape[2], d.shape[3]
        dt = torch.promote_types(d.dtype, _F32)
        ah = _avg_mat(h, osz[0], d.device).to(dt)
        aw = _avg_mat(w, osz[1], d.device).to(dt)
        return torch.einsum("bchw,ph,qw->bcpq", d.to(dt), ah, aw)

    return apply_op(_f, data, name="adaptive_avg_pooling_2d")


_export(adaptive_avg_pooling_2d,
        aliases=("AdaptiveAvgPooling2D", "_contrib_AdaptiveAvgPooling2D"))


# --- misc contrib ------------------------------------------------------------

def quadratic(data, a=0.0, b=0.0, c=0.0, **kwargs):
    """Reference tutorial op ``_contrib_quadratic`` (``quadratic_op.cc``):
    a*x^2 + b*x + c."""
    return apply_op(lambda x: a * x * x + b * x + c, data, name="quadratic")


_export(quadratic, aliases=("_contrib_quadratic",))


def index_array(data, axes=None, **kwargs):
    """Reference ``_contrib_index_array`` (``index_array.cc``): for each
    element its coordinate vector → shape data.shape + (len(axes),),
    int64 (the reference's index dtype)."""

    def _f(d):
        nd = d.dim()
        ax = list(range(nd)) if axes is None else [x % nd for x in axes]
        grids = torch.meshgrid(*[torch.arange(s, device=d.device)
                                 for s in d.shape], indexing="ij")
        return torch.stack([grids[x] for x in ax], dim=-1)

    return apply_op(_f, data, name="index_array", no_grad=True)


_export(index_array, aliases=("_contrib_index_array",))


def allclose(a, b, rtol=1e-05, atol=1e-08, equal_nan=True, **kwargs):
    """Reference ``_contrib_allclose`` (``allclose_op.cc``): a 0-d float32
    1 or 0, on the device (nothing is read on the host)."""
    def _f(x, y):
        dt = torch.promote_types(x.dtype, y.dtype)
        return torch.isclose(x.to(dt), y.to(dt), rtol=rtol, atol=atol,
                             equal_nan=equal_nan).all().to(_F32)

    return apply_op(_f, a, b, name="allclose", no_grad=True)


_export(allclose, aliases=("_contrib_allclose",))


def arange_like(data, start=0.0, step=1.0, repeat=1, ctx=None, axis=None,
                **kwargs):
    """Reference ``_contrib_arange_like``: arange shaped like data (or its
    ``axis`` dim)."""

    def _f(d):
        n = d.numel() if axis is None else d.shape[axis]
        # reference kernel: out[i] = start + step * (i // repeat), any n
        idx = torch.arange(n, dtype=_F32, device=d.device)
        out = start + step * torch.div(idx, repeat, rounding_mode="floor")
        return out.reshape(d.shape) if axis is None else out

    return apply_op(_f, data, name="arange_like", no_grad=True)


_export(arange_like, aliases=("_contrib_arange_like",))


def index_copy(old_tensor, index_vector, new_tensor, **kwargs):
    """Reference ``_contrib_index_copy``: copy rows of new_tensor into
    old_tensor at index_vector positions."""
    return apply_op(
        lambda o, i, n: o.index_copy(0, i.to(torch.int64), n.to(o.dtype)),
        old_tensor, index_vector, new_tensor, name="index_copy")


_export(index_copy, aliases=("_contrib_index_copy",))


class _GradientMultiplier(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scalar):
        ctx.scalar = scalar
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scalar, None


def gradientmultiplier(data, scalar=1.0, **kwargs):
    """Reference ``_contrib_gradientmultiplier``
    (``gradient_multiplier_op.cc``): identity forward, grad × scalar."""
    return apply_op(lambda x: _GradientMultiplier.apply(x, scalar), data,
                    name="gradientmultiplier")


_export(gradientmultiplier, aliases=("_contrib_gradientmultiplier",))


def fft(data, compute_size=128, **kwargs):
    """Reference ``_contrib_fft`` (``src/operator/contrib/fft.cc``, cuFFT
    backed): real input (..., d) → interleaved re/im (..., 2d)."""

    def _f(x):
        out = torch.fft.fft(x.to(torch.complex64), dim=-1)
        return torch.stack([out.real, out.imag],
                           dim=-1).reshape(x.shape[:-1] + (-1,))

    return apply_op(_f, data, name="fft")


_export(fft, aliases=("_contrib_fft",))


def ifft(data, compute_size=128, **kwargs):
    """Reference ``_contrib_ifft``: interleaved re/im (..., 2d) → real
    (..., d), scaled by d (no 1/d, as the reference)."""

    def _f(x):
        z = x.to(_F32).reshape(x.shape[:-1] + (-1, 2))
        out = torch.fft.ifft(torch.complex(z[..., 0], z[..., 1]), dim=-1)
        return out.real * out.shape[-1]

    return apply_op(_f, data, name="ifft")


_export(ifft, aliases=("_contrib_ifft",))


# --- AMP casts (reference src/operator/tensor/amp_cast.cc) -----------------

def amp_cast(data, dtype="float16", **kwargs):
    """Cast for AMP."""
    dt = resolve_dtype(dtype)
    return apply_op(lambda x: x.to(dt), data, name="amp_cast")


_export(amp_cast, aliases=("_amp_cast",))


def amp_multicast(*data, num_outputs=None, cast_narrow=False, **kwargs):
    """Cast all inputs to a common dtype (widest, or narrowest when
    ``cast_narrow``; the first of equal widths)."""
    dts = [d._data.dtype for d in data]
    pick = min(dts, key=lambda d: d.itemsize) if cast_narrow else \
        max(dts, key=lambda d: d.itemsize)

    def _f(*xs):
        return tuple(x.to(pick) for x in xs)

    return apply_op(_f, *data, name="amp_multicast")


_export(amp_multicast, aliases=("_amp_multicast",))


# --- Deformable convolution (reference src/operator/contrib/
# deformable_convolution.cc and modulated_deformable_convolution.cc) --------

def _deform_sample(img, offs, mask, kernel, stride, dilate, pad, oh, ow):
    """Sample deformable-conv patches for one deformable group, batched.

    img (B, C, H, W); offs (B, 2*KH*KW, OH, OW) with channel layout
    [(y, x) per kernel tap, taps in row-major (kh, kw) order — the
    reference's ordering]; mask (B, KH*KW, OH, OW) or None (DCNv2
    modulation, multiplied into sampled values).  → (B, C, KH*KW, OH, OW).
    Out-of-bounds bilinear samples contribute 0 (the zero-padding
    contract, as ROIAlign's).  Coordinates stay at least f32 whatever
    img's dtype."""
    kh, kw = kernel
    sh, sw = stride
    dh, dw = dilate
    ph, pw = pad
    b = img.shape[0]
    dev = img.device
    ct = torch.promote_types(_F32, offs.dtype)
    k = torch.arange(kh * kw, device=dev)
    ki, kj = k // kw, k % kw
    oi = torch.arange(oh, device=dev)
    oj = torch.arange(ow, device=dev)
    base_y = (oi[None, :, None] * sh - ph
              + ki[:, None, None] * dh).to(ct)   # (K, OH, 1)
    base_x = (oj[None, None, :] * sw - pw
              + kj[:, None, None] * dw).to(ct)   # (K, 1, OW)
    off = offs.reshape(b, kh * kw, 2, oh, ow).to(ct)
    ys = base_y + off[:, :, 0]
    xs = base_x + off[:, :, 1]
    vals = _bilinear(img, torch.arange(b, device=dev), ys.reshape(b, -1),
                     xs.reshape(b, -1))   # (B, C, K*OH*OW)
    vals = vals.reshape(b, img.shape[1], kh * kw, oh, ow)
    if mask is not None:
        vals = vals * mask[:, None]
    return vals


def _deform_conv_impl(d, off, w, bias, msk, kernel, stride, dilate, pad,
                      num_group, num_deformable_group):
    kh, kw = kernel
    ch = d.shape[1]
    oh = (d.shape[2] + 2 * pad[0] - (dilate[0] * (kh - 1) + 1)) \
        // stride[0] + 1
    ow = (d.shape[3] + 2 * pad[1] - (dilate[1] * (kw - 1) + 1)) \
        // stride[1] + 1
    cpg = ch // num_deformable_group           # channels per deform group
    k2 = kh * kw
    parts = []
    for g in range(num_deformable_group):
        m = None if msk is None else msk[:, g * k2:(g + 1) * k2]
        parts.append(_deform_sample(
            d[:, g * cpg:(g + 1) * cpg], off[:, g * 2 * k2:(g + 1) * 2 * k2],
            m, kernel, stride, dilate, pad, oh, ow))
    patches = torch.cat(parts, dim=1)  # (B, C, K, OH, OW)
    # grouped contraction: weight (O, C/g, KH, KW)
    o_total = w.shape[0]
    dt = torch.promote_types(patches.dtype, w.dtype)
    wg = w.reshape(num_group, o_total // num_group, ch // num_group,
                   k2).to(dt)
    pg = patches.reshape(patches.shape[0], num_group, ch // num_group, k2,
                         oh, ow).to(dt)
    out = torch.einsum("bgckij,gock->bgoij", pg, wg)
    out = out.reshape(patches.shape[0], o_total, oh, ow)
    if bias is not None:
        out = out + bias[None, :, None, None]
    return out.to(d.dtype)


def deformable_convolution(data, offset, weight, bias=None, kernel=(3, 3),
                           stride=(1, 1), dilate=(1, 1), pad=(0, 0),
                           num_filter=None, num_group=1,
                           num_deformable_group=1, no_bias=False, **kwargs):
    """Reference ``_contrib_DeformableConvolution`` (DCNv1, Dai et al.):
    data (B, C, H, W), offset (B, 2*KH*KW*num_deformable_group, OH, OW),
    weight (num_filter, C/num_group, KH, KW).  The per-tap bilinear
    samples are gathered for every output position, then one grouped
    product contracts them with the weight."""
    kernel = _tup(kernel, 2, "kernel")
    stride = _tup(stride, 2, "stride")
    dilate = _tup(dilate, 2, "dilate")
    pad = _tup(pad, 2, "pad")

    def _f(*args):
        if no_bias or bias is None:
            d, off, w = args
            b = None
        else:
            d, off, w, b = args
        return _deform_conv_impl(d, off, w, b, None, kernel, stride, dilate,
                                 pad, num_group, num_deformable_group)

    ins = [data, offset, weight] + \
        ([] if (no_bias or bias is None) else [bias])
    return apply_op(_f, *ins, name="deformable_convolution")


_export(deformable_convolution,
        aliases=("DeformableConvolution", "_contrib_DeformableConvolution"))


def modulated_deformable_convolution(data, offset, mask, weight, bias=None,
                                     kernel=(3, 3), stride=(1, 1),
                                     dilate=(1, 1), pad=(0, 0),
                                     num_filter=None, num_group=1,
                                     num_deformable_group=1, no_bias=False,
                                     **kwargs):
    """Reference ``_contrib_ModulatedDeformableConvolution`` (DCNv2): like
    DCNv1 plus a per-tap modulation mask (B, KH*KW*num_deformable_group,
    OH, OW) multiplied into the sampled values (caller applies sigmoid,
    matching the reference contract)."""
    kernel = _tup(kernel, 2, "kernel")
    stride = _tup(stride, 2, "stride")
    dilate = _tup(dilate, 2, "dilate")
    pad = _tup(pad, 2, "pad")

    def _f(*args):
        if no_bias or bias is None:
            d, off, msk, w = args
            b = None
        else:
            d, off, msk, w, b = args
        return _deform_conv_impl(d, off, w, b, msk, kernel, stride, dilate,
                                 pad, num_group, num_deformable_group)

    ins = [data, offset, mask, weight] + \
        ([] if (no_bias or bias is None) else [bias])
    return apply_op(_f, *ins, name="modulated_deformable_convolution")


_export(modulated_deformable_convolution,
        aliases=("ModulatedDeformableConvolution",
                 "_contrib_ModulatedDeformableConvolution"))
