"""A configuration that names the segment filter: its stream of whole
frames, its plain classifier, its cell end to end and its faults (CPU at
tiny sizes; one test on the card).

The classify cell here is count-1080p with the key added in the test, so
that no committed cell is needed for it."""

import copy
import hashlib
import time

import numpy as np
import pytest
import torch

import swiftwatcher_tpu_torch.models.classifier as classifier
import swiftwatcher_tpu_torch.models.squeezenet as squeezenet
import swiftwatcher_tpu_torch.pipeline.runner as runner
from swiftwatcher_tpu_torch.config import config_with_overrides
from swiftwatcher_tpu_torch.models.preprocess import pack_canvases, preprocess_batch, resize_coeffs
from swtbench import compare, control, roofline, run, spec, traffic
from swtbench.reference import classify
from swtbench.reference.localize import regions
from swtbench.source import StreamSource

WEIGHTS = "swiftwatcher_tpu_torch/models/segment_classifier.npz"
# the parameters of the original's transform, as a filter configuration
# states them beside count-1080p's
CNN = {"min_seg_size": [24, 24], "cnn_input_size": 224, "cnn_resize_to": 24,
       "cnn_mean": [0.485, 0.456, 0.406], "cnn_std": [0.229, 0.224, 0.225]}
# sha256 (first 16 hex digits) of the parent generator's gray crops and
# first frame at 1080 x 1920, two blocks, seed 2**31 + 5
PARENT = {"dusk": ("22ae89fdb68fd637", "52b45ade1ababa35"),
          "jitter": ("0d6cb811f6786240", "609b1b5484bf19a4"),
          "swarm": ("8cf5f6fda5f5cad0", "fcf527ccc6ef0f08")}
TRAFFIC = list(PARENT)
P = spec.load_json(spec.HERE / "configs" / "count-1080p.json")["pipeline"]


def _traffic(name, **kw):
    return dict(spec.load_json(spec.HERE / "traffic" / f"{name}.json"), **kw)


def _clip(name, H=240, W=320, seed=3, blocks=1, keep_bgr=True):
    crop, _ = regions(traffic.scene_corners(H, W), P)
    return traffic.generate(_traffic(name, blocks=blocks), seed, H, W, crop, keep_bgr=keep_bgr)


def classify_cell(traffic_name="dusk", limits=None):
    """count-1080p with the segment filter, under `traffic_name`."""
    base = spec.load_cell("count.dusk")
    conf = copy.deepcopy(base.config)
    conf["segment_filter"] = {"kind": "squeezenet", "weights": WEIGHTS}
    conf["pipeline"].update(CNN)
    crops = spec.Metric("crops", "crops", lambda r: r.crops)
    localize_count = spec.Metric("localize_count", "spans", lambda r: r.counters.get("localize"))
    return spec.Cell(f"classify.{traffic_name}", conf, _traffic(traffic_name), 1,
                     dict(base.limits, **(limits or {"logit_gap": 1e-3, "keep_off_pct": 0.0})),
                     base.end_to_end + [crops, localize_count], base.per_layer)


@pytest.mark.parametrize("name", TRAFFIC)
def test_the_gray_crops_are_the_parents(name):
    for keep_bgr in (False, True):
        clip = _clip(name, 1080, 1920, 2**31 + 5, blocks=2, keep_bgr=keep_bgr)
        got = tuple(hashlib.sha256(a.tobytes()).hexdigest()[:16]
                    for a in (clip.crops, clip.first_frame))
        assert got == PARENT[name]
        assert (clip.bgr is not None) == keep_bgr


@pytest.mark.parametrize("name", TRAFFIC)
def test_each_served_frame_crops_to_the_clips_gray(name):
    clip = _clip(name, blocks=2)
    full = traffic.full_frames(clip)
    N = len(clip.crops)
    (x1, y1), (x2, y2) = clip.crop
    src = StreamSource(clip, max_frames=N + 30, frames=full)
    frames, numbers, _ = src.get_window(N + 30)
    assert numbers == list(range(N + 30))
    for fn, f in zip(numbers[:-1], frames):
        assert np.shares_memory(f, full)
        assert np.array_equal(traffic.gray_of_bgr(f[y1:y2, x1:x2]), clip.crops[fn % N])
        outside = np.ones(f.shape[:2], bool)
        outside[y1:y2, x1:x2] = False
        assert np.array_equal(f[outside], clip.first_frame[outside])


def _serve(src, kind, n):
    """(gray crops, numbers) of the next n frames, by either mode."""
    if kind == "gray":
        out, numbers, stamps = src.get_gray_crop_window(n)
    else:
        frames, numbers, stamps = src.get_window(n)
        (x1, y1), (x2, y2) = src._clip.crop
        out = np.stack([traffic.gray_of_bgr(f[y1:y2, x1:x2]) for f in frames])
        assert all(f.shape == src.frame_shape for f in frames)
    assert stamps == numbers
    return out, numbers


@pytest.mark.parametrize("case", ["inclusive_end", "deadline"])
def test_get_window_keeps_the_gray_streams_contract(case):
    clip = _clip("dusk")
    N = len(clip.crops)
    sides = {}
    for kind in ("gray", "frames"):
        src = StreamSource(clip, max_frames=N + 5 if case == "inclusive_end" else 10 * N,
                           frames=traffic.full_frames(clip))
        src.enable_gray_crop_stream(clip.crop) if kind == "gray" else None
        served = []
        if case == "deadline":
            served.append(_serve(src, kind, 21))
            src.deadline = time.perf_counter() - 1.0
        served += [_serve(src, kind, n) for n in (N, 21, 21)]
        sides[kind] = (served, src.read_errors, src.frames_read, src.end_frame,
                       src.total_frames, src.next_frame_number)
    (gray, *rest_g), (frames, *rest_f) = sides["gray"], sides["frames"]
    assert rest_g == rest_f
    for (a, na), (b, nb) in zip(gray, frames):
        assert na == nb and np.array_equal(a, b)
    if case == "inclusive_end":
        # N + 5 is the inclusive end: the last good frame again, one read error
        assert rest_g[0] == 1 and -1 in gray[-1][1]
    else:
        # the feed ended after the window being served at the deadline
        assert rest_g[2] == rest_g[3] == 21 + N and rest_g[0] == 1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_plain_classifier_agrees_with_the_port(seed, tmp_path):
    rng = np.random.default_rng(seed)
    params = squeezenet.random_params(rng)
    for k in params:
        if k.endswith("bias"):
            params[k] = torch.from_numpy(rng.normal(0, 0.1, params[k].shape).astype(np.float32))
    npz = tmp_path / "w.npz"
    np.savez(npz, **squeezenet.params_to_jax(params))
    p = dict(CNN, cnn_input_size=96)
    cfg = config_with_overrides(["cnn_input_size=96"])
    frame = rng.integers(0, 256, (120, 160, 3), np.uint8)
    boxes = [[int(y), int(x), int(y) + int(h), int(x) + int(w)]
             for y, x, h, w in zip(rng.integers(20, 60, 8), rng.integers(20, 90, 8),
                                   rng.integers(1, 40, 8), rng.integers(1, 40, 8))]
    origin = (6, 9)
    crop_region = [origin, (150, 110)]
    inputs = [classify.network_input(frame, b, origin, p) for b in boxes]
    ref = classify.logits(classify.load_weights(npz, "cpu"), inputs)
    filt = classifier.SqueezeNetSegmentFilter.from_weights(npz, cfg, "cpu")
    images = [classifier.extract_segment_image(frame, b, crop_region, cfg.min_seg_size)
              for b in boxes]
    canv, hs, ws = pack_canvases(images, 64)
    table = torch.from_numpy(resize_coeffs(np.arange(1, 65), 64, 24)).double()
    x = preprocess_batch(torch.from_numpy(canv), table[torch.from_numpy(ws) - 1],
                         table[torch.from_numpy(hs) - 1], cfg)
    mine = squeezenet.forward(filt.params, x).double().numpy()
    # float32 against float64 through 26 convolutions: 1e-5 of the
    # largest logit is some hundred float32 roundings of it
    assert np.abs(mine - ref).max() <= 1e-5 * max(1.0, np.abs(ref).max())
    assert np.array_equal(filt.classify_images(images), ref.argmax(1) == 1)
    ctl = classify.logits(classify.load_weights(npz, "cpu"), inputs, "tf32")
    assert np.abs(ctl - ref).max() > 10 * np.abs(mine - ref).max()


def test_the_network_input_follows_the_transform():
    frame = np.zeros((50, 60, 3), np.uint8)
    frame[20:30, 25:35] = (10, 20, 200)
    x = classify.network_input(frame, [12, 17, 22, 27], (8, 8), CNN)
    assert x.shape == (3, 224, 224)
    # the BGR bytes go in as they are: the first channel is blue's 10
    centre = x[:, 112, 112] * np.asarray(CNN["cnn_std"]) + np.asarray(CNN["cnn_mean"])
    np.testing.assert_allclose(centre * 255, [10, 20, 200], atol=1e-9)
    np.testing.assert_allclose(x[:, 0, 0], -np.asarray(CNN["cnn_mean"]) / CNN["cnn_std"])
    assert classify.expand_box([5, 5, 6, 8], (24, 24)) == [-6, -5, 18, 19]
    assert classify.network_input(frame, [200, 200, 201, 201], (8, 8), CNN) is None


def test_the_forward_count_is_torchs():
    from torch.utils.flop_counter import FlopCounterMode

    w = classify.load_weights(spec.ROOT / WEIGHTS, "cpu")
    with FlopCounterMode(display=False) as counter:
        classify.forward(w, torch.zeros(3, 3, 224, 224, dtype=torch.float64))
    n_bytes, ops = roofline.squeezenet_forward(3, 224)
    assert ops == counter.get_total_flops()
    assert n_bytes == 4 * (3 * (3 * 224 * 224 + 2) + sum(v.numel() for v in w.values()))


@pytest.mark.parametrize("name", ["dusk", "swarm"])
def test_a_classify_cell_is_correct_on_the_cpu(name, tiny):
    cell = classify_cell(name)
    result, notes = run.run_cell(cell, 2**31 + 11, 2.0, False, "cpu", shrink=tiny)
    assert result["correct"], notes
    checks = result["checks"]
    assert checks["keep_off_pct"]["value"] == 0.0 and checks["logit_gap"]["value"] < 1e-4
    assert result["metrics"]["crops"]["value"] > 0
    assert result["metrics"]["localize_count"]["value"] > 0
    assert any(n.startswith("classify crops") for n in notes)


def test_a_cell_without_the_key_reports_no_crops(tiny):
    cell = classify_cell()
    del cell.config["segment_filter"]
    del cell.limits["logit_gap"], cell.limits["keep_off_pct"]
    result, notes = run.run_cell(cell, 2**31 + 11, 2.0, False, "cpu", shrink=tiny)
    assert result["correct"], notes
    assert "crops" not in result["metrics"]
    assert not any("logit_gap" in n or "classify crops" in n for n in notes)


def _nudged_bias(monkeypatch):
    real = classifier.SqueezeNetSegmentFilter.from_weights.__func__

    def from_weights(cls, *a, **kw):
        filt = real(cls, *a, **kw)
        filt.params["classifier.1.bias"] = filt.params["classifier.1.bias"] + 0.01
        return filt
    monkeypatch.setattr(classifier.SqueezeNetSegmentFilter, "from_weights",
                        classmethod(from_weights))


def _inverted_keeps(monkeypatch):
    real = squeezenet.forward
    monkeypatch.setattr(squeezenet, "forward", lambda params, x: real(params, x).flip(1))


def _one_pixel_off(monkeypatch):
    real = classifier.extract_segment_image

    def extract(frame_bgr, bbox, crop_region, min_size):
        (x, y), corner = crop_region
        return real(frame_bgr, bbox, [(x + 1, y), corner], min_size)
    monkeypatch.setattr(classifier, "extract_segment_image", extract)


def _previous_frame(monkeypatch):
    real = runner.pack_fused

    def previous(f):
        base = f.base
        if base is None or base.ndim != 4:
            return f
        i = (f.__array_interface__["data"][0] - base.__array_interface__["data"][0]) // f.nbytes
        return base[(i - 1) % len(base)]

    def pack_fused(segment_filter, view, frames, crop_region, timers=None):
        return real(segment_filter, view, {k: previous(f) for k, f in frames.items()},
                    crop_region, timers=timers)
    monkeypatch.setattr(runner, "pack_fused", pack_fused)


@pytest.mark.parametrize("fault", [_nudged_bias, _inverted_keeps, _one_pixel_off, _previous_frame])
def test_a_classify_fault_is_not_correct(fault, tiny, monkeypatch):
    fault(monkeypatch)
    result, notes = run.run_cell(classify_cell(), 2**31 + 77, 2.0, False, "cpu", shrink=tiny)
    assert not result["correct"], notes
    assert result["checks"]["logit_gap"]["value"] > 1e-3, notes


@pytest.mark.card
def test_a_classify_cell_on_the_card(card, tiny):
    run.pin_caches()
    result, notes = run.run_cell(classify_cell("swarm"), 2**31 + 5, 4.0, False, card,
                                 shrink=dict(tiny, height=1080, width=1920, blocks=1,
                                             batch_windows=8))
    print(*notes, sep="\n")
    assert result["correct"], notes
    assert result["metrics"]["crops"]["value"] > 0


def test_the_tf32_control_moves_the_logits_more_than_the_program(tiny):
    cell = classify_cell()
    program, ctl, conv = control.readings(cell, [31], 3 * 84 * 2, True, ["tf32"], "cpu",
                                          shrink=tiny)
    assert [r["side"] for r in (program, ctl, conv)] == ["program", "tf32", "tf32_conv"]
    assert program["numbers"]["keep_off_pct"] == 0.0
    assert not compare.judge(ctl["numbers"], cell.limits)[0]
    # the convolutions alone: only the logits move, and by more than the
    # program's float32 moves them
    assert conv["numbers"]["logit_gap"] > 10 * program["numbers"]["logit_gap"]
    assert all(v == 0.0 for k, v in conv["numbers"].items() if k not in ("logit_gap", "keep_off_pct"))


@pytest.mark.card
@pytest.mark.parametrize("name", ["dusk", "swarm"])
def test_no_frame_of_the_traffic_overflows_the_device_tracker(name, card):
    """The reference classifies every segment of a frame, the device
    tracker only its first max_tracks: at count-1080p's size no frame of
    the base clip holds more."""
    from swtbench.reference import run_reference

    p = dict(P)
    H, W = 1080, 1920
    corners = traffic.scene_corners(H, W)
    crop, _ = regions(corners, p)
    clip = traffic.generate(_traffic(name), 2**31 + 9, H, W, crop)
    ref = run_reference(clip.first_frame, clip.crops, corners, p, len(clip.crops), card)
    most = max(map(len, ref["segments"]))
    print(name, "most segments in a frame", most)
    assert most <= config_with_overrides([]).max_tracks
