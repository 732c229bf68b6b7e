"""RecordIO of the PyTorch/CUDA port against the JAX package: the same
records give byte-identical ``.rec`` and ``.idx`` files, each package
reads the other's, and ``IRHeader``/``pack_img`` round trips agree."""
import numpy as np
import pytest

from mxnet_tpu import recordio as jrec

from mxnet_tpu_torch import recordio as trec
from mxnet_tpu_torch.base import MXNetError


def _payloads(n=25, seed=0):
    rng = np.random.RandomState(seed)
    # lengths 0..4001 cover every pad width (0-3 bytes)
    return [rng.bytes(int(rng.randint(0, 4002))) for _ in range(n)]


def _write(mod, path, payloads):
    rec = mod.MXRecordIO(str(path), "w")
    for p in payloads:
        rec.write(p)
    rec.close()


def _write_indexed(mod, idx, path, payloads, keys):
    rec = mod.MXIndexedRecordIO(str(idx), str(path), "w")
    for k, p in zip(keys, payloads):
        rec.write_idx(k, p)
    rec.close()


def test_rec_bytes_identical_and_cross_read(tmp_path):
    payloads = _payloads()
    _write(jrec, tmp_path / "j.rec", payloads)
    _write(trec, tmp_path / "t.rec", payloads)
    assert (tmp_path / "j.rec").read_bytes() == \
        (tmp_path / "t.rec").read_bytes()
    for reader_mod, name in ((trec, "j.rec"), (jrec, "t.rec")):
        rd = reader_mod.MXRecordIO(str(tmp_path / name), "r")
        got = []
        while True:
            item = rd.read()
            if item is None:
                break
            got.append(item)
        rd.close()
        assert got == payloads


def test_indexed_bytes_identical_and_random_access(tmp_path):
    payloads = _payloads(17, seed=1)
    keys = list(np.random.RandomState(2).permutation(100)[:17])
    _write_indexed(jrec, tmp_path / "j.idx", tmp_path / "j.rec", payloads,
                   keys)
    _write_indexed(trec, tmp_path / "t.idx", tmp_path / "t.rec", payloads,
                   keys)
    for ext in ("rec", "idx"):
        assert (tmp_path / f"j.{ext}").read_bytes() == \
            (tmp_path / f"t.{ext}").read_bytes()
    rd = trec.MXIndexedRecordIO(str(tmp_path / "j.idx"),
                                str(tmp_path / "j.rec"), "r")
    assert rd.keys == keys
    for k in reversed(keys):
        assert rd.read_idx(k) == payloads[keys.index(k)]
    rd.close()


@pytest.mark.parametrize("label", [3.0, [1.0, 2.5, -4.0]])
def test_irheader_pack_unpack_matches(label):
    header = (0, label, 7, 9)
    payload = b"\x01\x02\x03"
    packed = trec.pack(header, payload)
    assert packed == jrec.pack(header, payload)
    th, ts = trec.unpack(packed)
    jh, js = jrec.unpack(packed)
    assert ts == js == payload
    assert (th.flag, th.id, th.id2) == (jh.flag, jh.id, jh.id2)
    np.testing.assert_array_equal(np.asarray(th.label),
                                  np.asarray(jh.label))


@pytest.mark.parametrize("fmt", [".jpg", ".png"])
def test_pack_img_matches(fmt):
    img = (np.random.RandomState(4).rand(12, 10, 3) * 255).astype(np.uint8)
    header = (0, 2.0, 5, 0)
    packed = trec.pack_img(header, img, quality=9 if fmt == ".png" else 95,
                           img_fmt=fmt)
    assert packed == jrec.pack_img(header, img,
                                   quality=9 if fmt == ".png" else 95,
                                   img_fmt=fmt)
    th, timg = trec.unpack_img(packed)
    jh, jimg = jrec.unpack_img(packed)
    assert th.label == jh.label == 2.0
    np.testing.assert_array_equal(timg, jimg)
    if fmt == ".png":
        np.testing.assert_array_equal(timg, img)  # lossless, BGR kept


def test_idx_blank_lines_tolerated_and_corrupt_line_named(tmp_path):
    payloads = _payloads(3, seed=5)
    _write_indexed(trec, tmp_path / "a.idx", tmp_path / "a.rec", payloads,
                   [0, 1, 2])
    text = (tmp_path / "a.idx").read_text()
    (tmp_path / "a.idx").write_text("\n" + text.replace("\n", "\n\n"))
    rd = trec.MXIndexedRecordIO(str(tmp_path / "a.idx"),
                                str(tmp_path / "a.rec"), "r")
    assert rd.keys == [0, 1, 2] and rd.read_idx(2) == payloads[2]
    rd.close()
    (tmp_path / "a.idx").write_text(text + "oops\n")
    with pytest.raises(MXNetError, match="corrupt index line 4"):
        trec.MXIndexedRecordIO(str(tmp_path / "a.idx"),
                               str(tmp_path / "a.rec"), "r")


def test_bad_magic_and_wrong_mode_raise(tmp_path):
    (tmp_path / "bad.rec").write_bytes(b"\x00" * 16)
    rd = trec.MXRecordIO(str(tmp_path / "bad.rec"), "r")
    with pytest.raises(MXNetError, match="bad magic"):
        rd.read()
    rd.close()
    wr = trec.MXRecordIO(str(tmp_path / "w.rec"), "w")
    with pytest.raises(MXNetError, match="write-only"):
        wr.read()
    wr.close()
