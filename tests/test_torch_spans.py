"""The port's stage spans (`utils.profiling.span`): ``rusty_sr.*`` ranges
on the profiler's clock while a torch profiler records, one shared null
context otherwise; where each one opens in the chunk loop, the per-call
preparation and the codec, and that recording them changes no output
byte.  On the CPU, but for the one test marked ``cuda`` (the chunk
loop's CUDA branch), which runs on the card with

    python -m pytest --noconftest tests/test_torch_spans.py -q
"""

import contextlib
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rusty_sr_tpu_torch.params import load_builtin
from rusty_sr_tpu_torch.parallel import tiling
from rusty_sr_tpu_torch.utils import imageio, native, profiling

TILE, CHUNK = 16, 4


def _img(seed, h, w):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                                dtype=np.uint8)


def _n_chunks(*shapes):
    tiles = sum(-(-h // TILE) * -(-w // TILE) for h, w in shapes)
    return -(-tiles // CHUNK)


def _traced(fn):
    """``fn()``'s result and its ``rusty_sr.*`` ranges as (name without
    the prefix, start, end), in start order."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    pre = profiling.SPAN_PREFIX
    spans = sorted(((e.name[len(pre):], e.time_range.start,
                     e.time_range.end) for e in prof.events()
                    if e.name.startswith(pre)), key=lambda s: s[1])
    return out, spans


def _count(spans, name):
    return sum(1 for n, _, _ in spans if n == name)


def _no_same_name_nesting(spans):
    last_end = {}
    for n, s, e in spans:
        assert s >= last_end.get(n, s), f"{n} nested in another {n}"
        last_end[n] = e


@pytest.fixture(scope="module")
def anime():
    return load_builtin("anime")


def test_span_off_is_one_shared_null_context():
    assert not torch.autograd._profiler_enabled()
    a, b = profiling.span("chunk.gather"), profiling.span("codec.encode")
    assert a is b is profiling._NULL
    assert isinstance(a, contextlib.nullcontext)
    with a:
        with b:                     # re-entered while open: still a no-op
            pass


@pytest.mark.parametrize("fast", [False, True])
def test_tiled_sr_spans_per_chunk_and_call(anime, fast):
    img = _img(1, 37, 45)
    kw = dict(tile=TILE, chunk=CHUNK, device="cpu",
              compute_dtype=torch.bfloat16 if fast else None)
    plain = tiling.tiled_sr(anime, img, 3, **kw)
    out, spans = _traced(lambda: tiling.tiled_sr(anime, img, 3, **kw))
    assert out.tobytes() == plain.tobytes()
    n = _n_chunks(img.shape[:2])
    for name in ("chunk.gather", "chunk.launch", "chunk.scatter"):
        assert _count(spans, name) == n, name
    for name in ("tiled.prepare", "tiled.outputs"):
        assert _count(spans, name) == 1, name
    # The card's waits and the pinned ring exist only on CUDA.
    assert not {"chunk.slot_wait", "chunk.fetch_wait",
                "chunk.pin"} & {s[0] for s in spans}
    _no_same_name_nesting(spans)


@pytest.mark.parametrize("engine", ["fused", "int8"])
def test_tiled_sr_prepare_once_on_every_engine(anime, engine):
    img = _img(2, 20, 21)
    if engine == "fused":
        img = img.astype(np.float32) / 255.0
    _, spans = _traced(lambda: tiling.tiled_sr(
        anime, img, 3, tile=TILE, chunk=CHUNK, engine=engine, device="cpu"))
    assert _count(spans, "tiled.prepare") == 1
    assert _count(spans, "chunk.launch") == _n_chunks(img.shape[:2])


def test_tiled_sr_batch_spans_nest_the_callback(anime):
    imgs = [_img(3, 30, 40), _img(4, 17, 16), _img(5, 40, 33)]
    kw = dict(tile=TILE, chunk=CHUNK, device="cpu")
    plain = tiling.tiled_sr_batch(anime, imgs, 3, **kw)
    done = []
    outs, spans = _traced(lambda: tiling.tiled_sr_batch(
        anime, imgs, 3, on_image_done=lambda i, o: done.append(i), **kw))
    assert done == [0, 1, 2]
    assert [o.tobytes() for o in outs] == [o.tobytes() for o in plain]
    n = _n_chunks(*(im.shape[:2] for im in imgs))
    for name in ("chunk.gather", "chunk.launch", "chunk.scatter"):
        assert _count(spans, name) == n, name
    for name in ("tiled.prepare", "tiled.outputs"):
        assert _count(spans, name) == 1, name
    scatters = [(s, e) for name, s, e in spans if name == "chunk.scatter"]
    callbacks = [(s, e) for name, s, e in spans
                 if name == "batch.on_image_done"]
    assert len(callbacks) == len(imgs)
    for s, e in callbacks:
        assert any(a <= s and e <= b for a, b in scatters)
    _no_same_name_nesting(spans)


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_scatter_fallback_span_only_on_the_numpy_path(anime, monkeypatch,
                                                      path):
    """``scatter.fallback`` opens inside each ``chunk.scatter`` that takes
    the numpy loop, and never where the native scatter runs."""
    if path == "native" and not native.available():
        pytest.skip("the native tile library did not build here: "
                    + native.build_error("tileio"))
    if path == "numpy":
        monkeypatch.setattr(native, "_load_build", lambda name: None)
    imgs = [_img(10, 30, 40), _img(11, 17, 16)]
    kw = dict(tile=TILE, chunk=CHUNK, device="cpu")
    plain = tiling.tiled_sr_batch(anime, imgs, 3, **kw)
    outs, spans = _traced(lambda: tiling.tiled_sr_batch(anime, imgs, 3,
                                                        **kw))
    assert [o.tobytes() for o in outs] == [o.tobytes() for o in plain]
    n = _n_chunks(*(im.shape[:2] for im in imgs))
    assert _count(spans, "chunk.scatter") == n
    assert _count(spans, "scatter.fallback") == (n if path == "numpy" else 0)
    scatters = [(s, e) for name, s, e in spans if name == "chunk.scatter"]
    for name, s, e in spans:
        if name == "scatter.fallback":
            assert any(a <= s and e <= b for a, b in scatters)


def test_png_encode_span_counts_native_encodes_only():
    if not native.png_available():
        pytest.skip("the native PNG encoder is not available here")
    img = _img(6, 23, 31)
    plain = native.png_encode(img)
    (data, declined), spans = _traced(
        lambda: (native.png_encode(img), native.png_encode(img[:, :, 0])))
    assert data == plain and declined is None
    assert [n for n, _, _ in spans] == ["codec.encode"]


def test_load_image_u8_span_once_a_load(tmp_path):
    img = _img(7, 19, 26)
    path = str(tmp_path / "a.png")
    imageio.save_image_u8(path, img)
    got, spans = _traced(lambda: imageio.load_image_u8(path))
    assert got.tobytes() == img.tobytes()
    assert [n for n, _, _ in spans] == ["codec.decode"]


@pytest.mark.cuda
def test_cuda_chunk_loop_spans(anime):
    """On the card every chunk also waits for its slot and its download;
    a call with new specs pins its ring (at most ``_MAX_INFLIGHT + 1``
    slots), the next call with the same specs none; the card's copies of
    the ranges are user annotations, which a trace reader tells from
    kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the chunk loop's pinned ring and "
                    "events exist only there")
    imgs = [_img(8, 70, 90), _img(9, 50, 41)]
    kw = dict(tile=TILE, chunk=CHUNK, device="cuda",
              compute_dtype=torch.bfloat16)
    plain = tiling.tiled_sr_batch(anime, imgs, 3, **kw)
    n = _n_chunks(*(im.shape[:2] for im in imgs))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        outs = tiling.tiled_sr_batch(anime, imgs, 3, **kw)
        torch.cuda.synchronize()
    assert [o.tobytes() for o in outs] == [o.tobytes() for o in plain]
    pre = profiling.SPAN_PREFIX
    events = prof.profiler.kineto_results.events()
    host = [e.name()[len(pre):] for e in events if e.name().startswith(pre)
            and str(e.device_type()).split(".")[-1].upper() == "CPU"]
    for name in ("chunk.slot_wait", "chunk.gather", "chunk.launch",
                 "chunk.fetch_wait", "chunk.scatter"):
        assert host.count(name) == n, name
    assert host.count("chunk.pin") == 0      # the ring of the call above
    assert host.count("batch.on_image_done") == 0
    dev = [e for e in events if e.name().startswith(pre)
           and str(e.device_type()).split(".")[-1].upper() == "CUDA"]
    assert all(e.is_user_annotation() for e in dev)

    tiling._RINGS.clear()
    _, spans = _traced(lambda: tiling.tiled_sr_batch(anime, imgs, 3, **kw))
    assert 0 < _count(spans, "chunk.pin") <= min(n, tiling._MAX_INFLIGHT + 1)


# --- scripts/span_split.py: the reader of these spans in a traced slice ---

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "scripts", "span_split.py")


def _split_module():
    spec = importlib.util.spec_from_file_location("span_split", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reading(counts, program):
    from portbench.tracing import Reading
    r = Reading(2.0, [("conv_stage_kernel", 0.5, 1.0)], [],
                [("upscale_batch", 0.0, 2.0)], counts)
    r.program, r.annotations = program, 0
    return r


def test_split_reads_the_chunk_loop_shares():
    split = _split_module().split
    out = split(_reading({"calls": 2}, [
        ("rusty_sr.chunk.gather", 0.0, 0.2),
        ("rusty_sr.chunk.launch", 0.2, 0.3),
        ("rusty_sr.chunk.fetch_wait", 0.9, 1.0),
        ("rusty_sr.chunk.scatter", 1.0, 1.6),
        ("rusty_sr.batch.on_image_done", 1.1, 1.2),
        ("rusty_sr.chunk.slot_wait", 1.6, 1.7),
        ("rusty_sr.tiled.outputs", 1.7, 1.8)]))
    assert out["gather_pct"] == pytest.approx(10.0)
    assert out["scatter_pct"] == pytest.approx(25.0)   # less the callback
    assert out["launch_pct"] == pytest.approx(5.0)
    assert out["card_wait_pct"] == pytest.approx(10.0)
    assert out["outputs_pct"] == pytest.approx(5.0)
    assert out["slice_s_per_call"] == pytest.approx(1.0)
    assert out["spans"]["rusty_sr.chunk.scatter"] == [1, pytest.approx(0.6)]
    # the gap before the kernel falls in launch, the one after in scatter
    assert [(g[0], g[2]) for g in out["idle_gaps"]] == [
        ("rusty_sr.chunk.scatter", 1), ("rusty_sr.chunk.launch", 1)]
    assert out["kernels_named_rusty_sr"] == 0
    assert out["scatter_fallbacks"] == 0
    assert out["scatter_gb_s"] is None       # no factor, no HR bytes


def test_split_reads_the_scatter_rate_and_fallbacks():
    split = _split_module().split
    counts = {"calls": 1, "lr_px": 1_000_000}
    program = [("rusty_sr.chunk.scatter", 0.0, 0.5),
               ("rusty_sr.scatter.fallback", 0.1, 0.2),
               ("rusty_sr.batch.on_image_done", 0.3, 0.4),
               ("rusty_sr.chunk.scatter", 1.0, 1.2),
               ("rusty_sr.scatter.fallback", 1.0, 1.1)]
    out = split(_reading(counts, program), factor=4)
    assert out["scatter_fallbacks"] == 2
    # 16 M HR pixels, 3 bytes each, over 0.6 s of scatter less callback
    assert out["scatter_gb_s"] == pytest.approx(3 * 16e6 / 0.6 / 1e9)
    assert out["scatter_pct"] == pytest.approx(30.0)


def test_split_reads_prepare_and_encode_per_request():
    split = _split_module().split
    enc = [("rusty_sr.codec.encode", 0.1, 0.11),
           ("rusty_sr.codec.encode", 1.1, 1.11)]
    prep = [("rusty_sr.tiled.prepare", 0.0, 0.003),
            ("rusty_sr.tiled.prepare", 1.0, 1.003)]
    counts = {"requests": 2, "hr_px": 4_000_000}
    out = split(_reading(counts, prep + enc))
    assert out["prepare_ms"] == pytest.approx(3.0)
    assert out["encode_mpix_s"] == pytest.approx(200.0)
    assert out["slice_ms_per_request"] == pytest.approx(1000.0)
    # an encode that did not run natively: no rate
    assert split(_reading(counts, prep + enc[:1]))["encode_mpix_s"] is None
    assert out["scatter_gb_s"] is None       # no scatter span


def test_split_reads_the_swinir_stages():
    split = _split_module().split
    program = [("rusty_sr.swinir.embed", 0.0, 0.1)] + [
        ("rusty_sr.swinir.rstb", 0.1 + 0.2 * g, 0.3 + 0.2 * g)
        for g in range(6)] + [("rusty_sr.swinir.upsample", 1.3, 1.7)]
    out = split(_reading({"calls": 1, "frames": 2}, program))
    assert out["swinir_groups"] == 6
    assert out["swinir_norm_plain"] == 0
    plain = [("rusty_sr.swinir.norm_plain", 0.05, 0.06),
             ("rusty_sr.swinir.norm_plain", 0.2, 0.21)]
    assert split(_reading({"calls": 1, "frames": 2}, program + plain))[
        "swinir_norm_plain"] == 2
    assert out["swinir_pct"] == {"embed": pytest.approx(5.0),
                                 "rstb": pytest.approx(60.0),
                                 "upsample": pytest.approx(20.0)}
    assert out["swinir_ms_per_frame"]["rstb"] == pytest.approx(600.0)
    # a slice without them reads none
    assert "swinir_pct" not in split(_reading({"calls": 1}, []))


def test_swinir_spans_per_stage():
    """One ``swinir.embed``, one ``swinir.rstb`` a residual group and one
    ``swinir.upsample`` a chunk, inside its ``chunk.launch``; a
    ``swinir.norm_plain`` for each add-and-normalise of the exact tier
    alone."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import swinir_reference as ref
    from rusty_sr_tpu_torch import api
    cfg = dict(embed_dim=24, in_chans=3, depths=[2, 2, 2], num_heads=[3] * 3,
               window_size=8, mlp_ratio=2, num_feat=16, upscale=4,
               out_chans=3, img_size=64, img_range=1.0,
               mean=[0.4488, 0.4371, 0.4040])
    tree = ref.draw_weights(3, cfg)
    frames = [_img(i, 16, 24) for i in range(3)]
    _, spans = _traced(lambda: api.upscale_batch(
        frames, weights=tree, chunk=2, fast=True, device="cpu"))
    chunks = _count(spans, "chunk.launch")
    assert chunks == 2
    assert _count(spans, "swinir.embed") == chunks
    assert _count(spans, "swinir.rstb") == 3 * chunks
    assert _count(spans, "swinir.upsample") == chunks
    # the fast tier calls the op (its plain version on the CPU), so no
    # add-and-normalise opens ``swinir.norm_plain``
    assert _count(spans, "swinir.norm_plain") == 0
    launches = [(s, e) for n, s, e in spans if n == "chunk.launch"]
    for n, s, e in spans:
        if n.startswith("swinir."):
            assert any(a <= s and e <= b for a, b in launches), n
    _no_same_name_nesting(spans)
    # the exact tier's are all plain: 2 * 6 blocks + 3 groups + 2 a chunk
    _, spans = _traced(lambda: api.upscale_batch(
        frames, weights=tree, chunk=2, fast=False, device="cpu"))
    assert _count(spans, "swinir.norm_plain") == 17 * chunks


def test_split_script_on_a_tiny_cell():
    p = subprocess.run(
        [sys.executable, SCRIPT, "--workload", "x4_frames_fast", "--seed",
         str(2 ** 31 + 5), "--seconds", "4", "--tiny", "--spans", "on,off"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    on, off = [json.loads(ln) for ln in p.stdout.splitlines()
               if ln.startswith("{")]
    assert (on["spans"], off["spans"]) == ("on", "off")
    counts = {k: c for k, (c, _) in on["split"]["spans"].items()}
    assert counts["rusty_sr.chunk.gather"] == counts["rusty_sr.chunk.scatter"]
    assert counts["rusty_sr.tiled.prepare"] >= 1
    assert on["split"]["scatter_gb_s"] > 0
    assert on["split"]["scatter_fallbacks"] == (
        0 if native.available() else counts["rusty_sr.chunk.scatter"])
    assert off["split"]["spans"] == {}
