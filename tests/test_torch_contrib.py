"""The contrib ops of the PyTorch/CUDA port against the JAX package:
every op of ``mxnet_tpu/ops/contrib.py`` under ``nd.contrib`` (and its
legacy ``nd`` aliases), forward and, where the reference differentiates
(``ROIAlign``, ``quadratic``, ``gradientmultiplier``, the deformable
convolutions), backward through each package's own autograd.

The same seeded numpy inputs go through both packages.  Float outputs
are held at ``rtol=atol=1e-5`` (f32; the reference's tests run with
x64 on, so some of its grids are float64 and are compared at the port's
f32); index and mask outputs, and every NMS row, exactly: NMS keeps
the same boxes in the same order, tied scores included (both sorts are
stable).  The NMS scan's ``topk`` restriction is held against the full-n
plain scan, and ``roi[0]`` is cast to int by truncation.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ops import contrib as tc

CPU = tmx.cpu()
TOL = dict(rtol=1e-5, atol=1e-5)


def _nd(pkg, a):
    a = np.asarray(a)
    return pkg.nd.array(a, ctx=CPU, dtype=a.dtype) if pkg is tmx else \
        pkg.nd.array(a, dtype=a.dtype)


def _np(out):
    outs = out if isinstance(out, (list, tuple)) else [out]
    return [np.asarray(o.asnumpy()) for o in outs]


def _both(name, arrays, **kw):
    """``nd.contrib.<name>`` on the same arrays in both packages."""
    res = []
    for pkg in (jmx, tmx):
        res.append(_np(getattr(pkg.nd.contrib, name)(
            *[_nd(pkg, a) for a in arrays], **kw)))
    return res


def _close(ref, got, exact=False, **tol):
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        assert r.shape == g.shape, (r.shape, g.shape)
        if exact:
            np.testing.assert_array_equal(g, r.astype(g.dtype))
        else:
            np.testing.assert_allclose(g, r.astype(g.dtype), **(tol or TOL))


def _boxes(rs, shape, size=1.0):
    """Random corner boxes (..., 4) inside [0, size]."""
    c = rs.uniform(0.1, 0.9, shape + (2,)) * size
    wh = rs.uniform(0.05, 0.5, shape + (2,)) * size
    return np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)


def _dets(rs, lead, n, classes=3, ties=False):
    """(lead..., n, 6) rows [cls, score, x1 y1 x2 y2], some invalid."""
    cls = rs.randint(0, classes, lead + (n, 1)).astype(np.float32)
    if ties:  # a handful of score values: many ties
        score = rs.choice([0.0, 0.3, 0.5, 0.9], lead + (n, 1))
    else:
        score = rs.uniform(-0.2, 1.0, lead + (n, 1))
    b = _boxes(rs, lead + (n,))
    return np.concatenate([cls, score.astype(np.float32), b], -1)


# --- box geometry ----------------------------------------------------------

@pytest.mark.parametrize("fmt", ["corner", "center"])
def test_box_iou(fmt):
    rs = np.random.RandomState(0)
    a, b = _boxes(rs, (2, 5)), _boxes(rs, (7,))
    _close(*_both("box_iou", [a, b], format=fmt))


# --- NMS -------------------------------------------------------------------

NMS_CASES = {
    "class_aware_topk": dict(topk=6, id_index=0, coord_start=2,
                             score_index=1, overlap_thresh=0.3),
    "force_suppress": dict(id_index=0, force_suppress=True,
                           overlap_thresh=0.2, valid_thresh=0.1),
    "no_ids": dict(id_index=-1, overlap_thresh=0.25),
    "background": dict(id_index=0, background_id=1, overlap_thresh=0.3),
    "center_in_corner_out": dict(id_index=0, in_format="center",
                                 out_format="corner", overlap_thresh=0.3),
    "corner_in_center_out": dict(id_index=0, out_format="center",
                                 overlap_thresh=0.3, topk=9),
}


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("case", sorted(NMS_CASES))
def test_box_nms(case, ties):
    rs = np.random.RandomState(1)
    d = _dets(rs, (2, 2), 24, ties=ties)
    ref, got = _both("box_nms", [d], **NMS_CASES[case])
    _close(ref, got, exact=True)
    assert (got[0][..., 0] == -1).any() and (got[0][..., 0] >= 0).any()


def test_box_nms_legacy_aliases():
    assert tmx.nd.box_nms is tmx.nd.contrib.box_nms is \
        tmx.nd.contrib.box_non_maximum_suppression is \
        tmx.nd._contrib_box_nms


def test_nms_topk_restriction_equals_the_full_scan():
    """Scanning only the first topk sorted boxes gives the full-n scan's
    mask with every box past topk invalid."""
    rs = np.random.RandomState(2)
    n, topk = 300, 40
    boxes = torch.from_numpy(_boxes(rs, (3, n)))
    valid = torch.from_numpy(rs.rand(3, n) > 0.2)
    cls = torch.from_numpy(rs.randint(0, 2, (3, n)).astype(np.float32))
    full = tc._nms_keep_plain(boxes, valid & (torch.arange(n) < topk), cls,
                              0.3)
    got = tc._nms_scan(boxes, valid & (torch.arange(n) < topk), cls, 0.3,
                       topk)
    assert torch.equal(got, full)
    assert full[:, :topk].any() and not full[:, topk:].any()


@pytest.mark.parametrize("g, n", [(32, 400), (1, 2000), (1, 10647),
                                  (32, 11200), (3, 23200), (1, 100000),
                                  (70000, 4)])
def test_nms_plan_holds_the_scratch_cap_and_covers_every_image(g, n):
    """The card's scan takes its images in chunks (``_nms_plan``) whose
    scratch stays within the cap, or one image a chunk when one image's
    scratch alone passes it (23,200 and 100,000 boxes), never more than
    the grid's 65,535; SSD-512's 32 x 400 is one chunk."""
    chunk = tc._nms_plan(g, n)
    scratch = 8 * tc._nms_image_words(n)
    assert 1 <= chunk <= min(g, 65535)
    assert chunk * scratch <= tc._NMS_SCRATCH_CAP or chunk == 1
    assert (chunk == 1) == (scratch * 2 > tc._NMS_SCRATCH_CAP or g == 1)
    if (g, n) == (32, 400):
        assert chunk == 32


def test_nms_plain_blocks_of_rows_match_one_block(monkeypatch):
    """The plain scan gives the same mask whatever block of rows makes
    its overlaps (one row at a time against all rows at once)."""
    rs = np.random.RandomState(3)
    boxes = torch.from_numpy(_boxes(rs, (2, 50)))
    valid = torch.from_numpy(rs.rand(2, 50) > 0.1)
    whole = tc._nms_keep_plain(boxes, valid, None, 0.2)
    monkeypatch.setattr(tc, "_PLAIN_CHUNK", 1)
    assert torch.equal(tc._nms_keep_plain(boxes, valid, None, 0.2), whole)


# --- bipartite matching ----------------------------------------------------

@pytest.mark.parametrize("kw", [dict(threshold=0.3),
                                dict(threshold=0.6, is_ascend=True),
                                dict(threshold=0.1, topk=2)])
def test_bipartite_matching(kw):
    rs = np.random.RandomState(4)
    w = rs.rand(2, 5, 4).astype(np.float32)
    _close(*_both("bipartite_matching", [w], **kw), exact=True)


# --- MultiBox --------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(sizes=(0.2, 0.4), ratios=(1, 2, 0.5)),
    dict(sizes=(0.5,), ratios=(1, 3), clip=True, steps=(0.1, 0.2),
         offsets=(0.3, 0.6))])
def test_multibox_prior(kw):
    x = np.zeros((2, 3, 5, 7), np.float32)
    _close(*_both("MultiBoxPrior", [x], **kw))


def _multibox_inputs(seed, b=2, m=4, nc=3):
    rs = np.random.RandomState(seed)
    x = np.zeros((1, 3, 6, 6), np.float32)
    anchors = jmx.nd.contrib.MultiBoxPrior(
        jmx.nd.array(x), sizes=(0.3, 0.5), ratios=(1, 2)).asnumpy()
    anchors = anchors.astype(np.float32)
    lab = -np.ones((b, m, 5), np.float32)
    for i in range(b):
        k = rs.randint(1, m + 1)
        lab[i, :k, 0] = rs.randint(0, nc, k)
        lab[i, :k, 1:] = _boxes(rs, (k,))
    cls_pred = rs.randn(b, nc + 1, anchors.shape[1]).astype(np.float32)
    return anchors, lab, cls_pred


@pytest.mark.parametrize("kw", [
    dict(), dict(negative_mining_ratio=3, negative_mining_thresh=0.5),
    dict(negative_mining_ratio=2, minimum_negative_samples=20,
         overlap_threshold=0.3, ignore_label=-2)])
def test_multibox_target(kw):
    ref, got = _both("MultiBoxTarget", list(_multibox_inputs(5)), **kw)
    _close(ref[:2], got[:2])
    _close(ref[2:], got[2:], exact=True)
    assert (got[2] > 0).any()


def test_multibox_detection():
    anchors, _lab, _ = _multibox_inputs(6)
    rs = np.random.RandomState(6)
    n = anchors.shape[1]
    logits = rs.randn(2, 4, n).astype(np.float32) * 3
    prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    loc = (rs.randn(2, n * 4) * 0.5).astype(np.float32)
    ref, got = _both("MultiBoxDetection", [prob, loc, anchors],
                     nms_threshold=0.4, nms_topk=30, threshold=0.05)
    # the same rows kept in the same order; decoded coordinates round
    # differently (XLA fuses the decode)
    _close([ref[0][..., :2]], [got[0][..., :2]], exact=True)
    _close(ref, got)


# --- ROI ops ---------------------------------------------------------------

def _rois(rs, r, b, size):
    box = _boxes(rs, (r,), size)
    # fractional batch indices: the op truncates them (1.7 -> 1)
    idx = (rs.randint(0, b, (r, 1)) + rs.choice([0.0, 0.3, 0.9], (r, 1)))
    return np.concatenate([idx, box], -1).astype(np.float32)


@pytest.mark.parametrize("kw", [
    dict(pooled_size=3, spatial_scale=0.5),
    dict(pooled_size=(2, 4), spatial_scale=0.25, sample_ratio=3,
         aligned=True)])
def test_roi_align_forward_and_backward(kw):
    rs = np.random.RandomState(7)
    data = rs.randn(2, 3, 9, 11).astype(np.float32)
    rois = _rois(rs, 5, 2, 40.0)
    rois[0, 1:] = [-6.0, -4.0, 3.0, 50.0]  # samples outside the map
    outs = []
    for pkg in (jmx, tmx):
        d = _nd(pkg, data)
        d.attach_grad()
        with pkg.autograd.record():
            y = pkg.nd.contrib.ROIAlign(d, _nd(pkg, rois), **kw)
            w = _nd(pkg, np.arange(np.prod(y.shape), dtype=np.float32)
                    .reshape(y.shape) / 100)
            loss = (y * w).sum()
        loss.backward()
        outs.append([y.asnumpy(), d.grad.asnumpy()])
    _close(*outs)


def test_roi_align_truncates_the_batch_index():
    data = np.stack([np.zeros((1, 4, 4)), np.ones((1, 4, 4))]
                    ).astype(np.float32)
    rois = np.array([[0.9, 0, 0, 3, 3], [1.7, 0, 0, 3, 3]], np.float32)
    ref, got = _both("ROIAlign", [data, rois], pooled_size=1)
    _close(ref, got)
    np.testing.assert_array_equal(got[0].ravel(), [0.0, 1.0])


def test_roi_pooling():
    rs = np.random.RandomState(8)
    data = rs.randn(2, 3, 10, 12).astype(np.float32)
    rois = _rois(rs, 4, 2, 30.0)
    _close(*_both("ROIPooling", [data, rois], pooled_size=(3, 2),
                  spatial_scale=0.3))


def _proposal_inputs(seed, ties):
    rs = np.random.RandomState(seed)
    b, a, h, w = 2, 6, 5, 7
    if ties:
        fg = rs.choice([0.2, 0.6, 0.8], (b, a, h, w))
    else:
        fg = rs.rand(b, a, h, w)
    cp = np.concatenate([1 - fg, fg], 1).astype(np.float32)
    bp = (rs.randn(b, 4 * a, h, w) * 0.3).astype(np.float32)
    bp[0, 2, 0, 0] = 30.0  # clipped to 10 before exp
    info = np.array([[80, 112, 1.0], [72, 100, 1.5]], np.float32)
    return cp, bp, info


@pytest.mark.parametrize("ties", [False, True])
def test_proposal(ties):
    kw = dict(rpn_pre_nms_top_n=60, rpn_post_nms_top_n=80, threshold=0.6,
              rpn_min_size=4, scales=(2, 4), ratios=(0.5, 1, 2),
              feature_stride=16, output_score=True)
    ref, got = _both("Proposal", list(_proposal_inputs(9, ties)), **kw)
    _close(ref, got)
    # zero rows, not -1, past the survivors
    assert got[0].shape == (160, 5) and (got[0][:, 1:] == 0).all(1).any()


# --- box coding, resizing, pooling ------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(std0=0.1, std1=0.1, std2=0.2,
                                             std3=0.2, clip=0.5,
                                             format="corner")])
def test_box_decode(kw):
    rs = np.random.RandomState(10)
    d = rs.randn(2, 6, 4).astype(np.float32)
    anc = _boxes(rs, (1, 6))
    _close(*_both("box_decode", [d, anc], **kw))


def test_box_encode():
    rs = np.random.RandomState(11)
    samples = rs.choice([0.0, 1.0], (2, 6)).astype(np.float32)
    matches = rs.randint(-1, 3, (2, 6)).astype(np.float32)
    anchors = _boxes(rs, (2, 6))
    refs = _boxes(rs, (2, 3))
    _close(*_both("box_encode", [samples, matches, anchors, refs]))


@pytest.mark.parametrize("kw", [dict(height=7, width=5),
                                dict(scale_height=2.0, scale_width=0.5)])
def test_bilinear_resize_2d(kw):
    x = np.random.RandomState(12).randn(2, 3, 6, 8).astype(np.float32)
    _close(*_both("BilinearResize2D", [x], **kw))


@pytest.mark.parametrize("size", [1, (3, 2), 4])
def test_adaptive_avg_pooling_2d(size):
    x = np.random.RandomState(13).randn(2, 3, 7, 5).astype(np.float32)
    _close(*_both("AdaptiveAvgPooling2D", [x], output_size=size))


# --- small ops ---------------------------------------------------------------

def _grad_pair(fn_name, x, cot, **kw):
    outs = []
    for pkg in (jmx, tmx):
        a = _nd(pkg, x)
        a.attach_grad()
        with pkg.autograd.record():
            y = getattr(pkg.nd.contrib, fn_name)(a, **kw)
            loss = (y * _nd(pkg, cot)).sum()
        loss.backward()
        outs.append([y.asnumpy(), a.grad.asnumpy()])
    return outs


def test_quadratic_and_gradientmultiplier_forward_and_backward():
    rs = np.random.RandomState(14)
    x = rs.randn(3, 4).astype(np.float32)
    cot = rs.randn(3, 4).astype(np.float32)
    _close(*_grad_pair("quadratic", x, cot, a=0.5, b=-2.0, c=3.0))
    ref, got = _grad_pair("gradientmultiplier", x, cot, scalar=-0.25)
    _close(ref, got)
    np.testing.assert_allclose(got[1], cot * -0.25, **TOL)


def test_index_array_arange_like_index_copy():
    x = np.zeros((2, 3, 4), np.float32)
    _close(*_both("index_array", [x]), exact=True)
    _close(*_both("index_array", [x], axes=(-1, 0)), exact=True)
    _close(*_both("arange_like", [x], start=1.5, step=0.5, repeat=3))
    _close(*_both("arange_like", [x], axis=1, start=-2.0))
    old = np.arange(12, dtype=np.float32).reshape(4, 3)
    new = -np.ones((2, 3), np.float32)
    _close(*_both("index_copy", [old, np.array([3, 1], np.float32), new]))


def test_allclose():
    a = np.array([1.0, 2.0, np.nan], np.float32)
    for b, kw in ((a + 1e-7, {}), (a + 1e-3, {}), (a, dict(equal_nan=False)),
                  (a * 1.01, dict(rtol=0.02))):
        ref, got = _both("allclose", [a, b.astype(np.float32)], **kw)
        assert got[0].shape == () and float(got[0]) == float(ref[0])


def test_fft_ifft():
    x = np.random.RandomState(15).randn(3, 8).astype(np.float32)
    ref, got = _both("fft", [x])
    _close(ref, got, rtol=1e-5, atol=1e-4)
    _close(*_both("ifft", [got[0]]), rtol=1e-5, atol=1e-4)


def test_amp_casts():
    a = np.ones((2, 2), np.float32)
    b = np.ones((2, 2), np.float16)
    for pkg in (jmx, tmx):
        x = pkg.nd.contrib.amp_cast(_nd(pkg, a), dtype="float16")
        assert np.dtype(x.asnumpy().dtype) == np.float16
        w = pkg.nd.contrib.amp_multicast(_nd(pkg, a), _nd(pkg, b),
                                         num_outputs=2)
        n = pkg.nd.contrib.amp_multicast(_nd(pkg, a), _nd(pkg, b),
                                         num_outputs=2, cast_narrow=True)
        assert [o.asnumpy().dtype for o in w] == [np.float32] * 2
        assert [o.asnumpy().dtype for o in n] == [np.float16] * 2


# --- deformable convolution --------------------------------------------------

@pytest.mark.parametrize("modulated", [False, True])
def test_deformable_convolution_forward_and_backward(modulated):
    rs = np.random.RandomState(16)
    b, c, h, w, o = 2, 4, 6, 5, 6
    kw = dict(kernel=(3, 3), stride=(1, 2), pad=(1, 1), num_filter=o,
              num_group=2, num_deformable_group=2)
    oh, ow = 6, 3
    data = rs.randn(b, c, h, w).astype(np.float32)
    off = (rs.randn(b, 2 * 9 * 2, oh, ow) * 1.5).astype(np.float32)
    wt = (rs.randn(o, c // 2, 3, 3) * 0.3).astype(np.float32)
    bias = rs.randn(o).astype(np.float32)
    mask = rs.rand(b, 9 * 2, oh, ow).astype(np.float32)
    cot = rs.randn(b, o, oh, ow).astype(np.float32)
    name = "ModulatedDeformableConvolution" if modulated else \
        "DeformableConvolution"
    ins = [data, off] + ([mask] if modulated else []) + [wt, bias]
    outs = []
    for pkg in (jmx, tmx):
        arrs = [_nd(pkg, a) for a in ins]
        for a in arrs:
            a.attach_grad()
        with pkg.autograd.record():
            y = getattr(pkg.nd.contrib, name)(*arrs, **kw)
            loss = (y * _nd(pkg, cot)).sum()
        loss.backward()
        outs.append([y.asnumpy()] + [a.grad.asnumpy() for a in arrs])
    _close(*outs, rtol=1e-4, atol=1e-4)
