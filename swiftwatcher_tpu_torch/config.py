"""Typed configuration of the counting pipeline.

The port's own copy of the JAX package's `PipelineConfig`: the same fields,
types, defaults and order, so one `--set field=value` string means the same
thing to both packages (tests/test_torch_host.py holds them equal).  Every
constant the reference hardcodes is a named field; the reference call site
of each default is cited inline (paths in the original swiftwatcher).

Fields of a stage the port does not have (the wire codec, which the port
does not port) keep their place and default and have no effect; the
comment says so.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """All tunables of the swift counting pipeline.

    Defaults replicate the reference exactly (see citations per field).
    """

    # ----- windowing -------------------------------------------------------
    # data_structures.py:120  FrameQueue(queue_size=21)
    window_size: int = 21

    # ----- RPCA / IALM ------------------------------------------------------
    # image_filtering.py:256  inexact_augmented_lagrange_multiplier defaults
    rpca_lambda: float = 0.01
    rpca_tol: float = 0.001
    rpca_max_iter: int = 100
    rpca_rho: float = 1.5            # image_filtering.py:277
    rpca_mu_cap: float = 1e7         # image_filtering.py:295 (mu*1e7 cap factor)

    # ----- motion post-filtering -------------------------------------------
    # data_structures.py:194  bilateral_blur(frame, 7, 15, 1)
    bilateral_d: int = 7
    bilateral_sigma_color: float = 15.0
    bilateral_sigma_space: float = 1.0
    # data_structures.py:198  thresh_to_zero(frame, 15)
    motion_threshold: int = 15
    # data_structures.py:202  grayscale_opening(frame, (3, 3))
    opening_size: Tuple[int, int] = (3, 3)

    # ----- segmentation -----------------------------------------------------
    # image_filtering.py:329: labels cast to uint8 -> max 255 distinct labels,
    # labels alias mod 256.  Table capacity of 256 reproduces that exactly
    # (slot k holds the union of all components whose compacted label = k).
    label_modulus: int = 256
    # Max CCL propagation sweeps on the slow path (bounded flood fill).
    ccl_max_iters: int = 256
    # __main__.py:78  min segment bbox size for crop extraction (--classify
    # and --export)
    min_seg_size: Tuple[int, int] = (24, 24)

    # ----- tracking ---------------------------------------------------------
    # segment_tracking.py:196  dist_cost = 2 ** (dist - 25)
    dist_cost_knee: float = 25.0
    # segment_tracking.py:241  angle_cost = 2 ** (angle_difference - 90)
    angle_cost_knee: float = 90.0
    # segment_tracking.py:254  non-match cost
    nonmatch_cost: float = 1.0
    # Track-table capacity of the device tracker (pipeline/tracking_device.py);
    # the host tracker has no capacity.
    max_tracks: int = 24
    # Exponent clamp of the device tracker's f32 costs; no effect on the
    # host tracker.
    cost_exp_clamp: float = 60.0

    # ----- event classification --------------------------------------------
    # event_classification.py:95  drop angles that are multiples of 15 deg
    false_angle_multiple: float = 15.0
    # Opt-in extension beyond the reference (0.0 = exact reference
    # behaviour): drop a false angle only when the path's first->last
    # displacement is below this many pixels, so a real dive at exactly
    # -90 degrees is kept.
    false_angle_min_disp: float = 0.0
    # event_classification.py:110-114  label 1 iff angle in (mode-30, mode+30]
    angle_band_halfwidth: float = 30.0
    # event_classification.py:124  36-bin histogram over [-180, 180]
    angle_hist_bins: int = 36
    # event_classification.py:131  mode only trusted inside (-135, -45)
    mode_valid_range: Tuple[float, float] = (-135.0, -45.0)
    default_mode: float = -90.0      # event_classification.py:139

    # ----- geometry ---------------------------------------------------------
    # image_filtering.py:50-51  crop box ratios (1.25w x 0.625w)
    crop_side_ratio: float = 0.125
    crop_up_ratio: float = 0.5
    crop_down_ratio: float = 0.125
    # image_filtering.py:72-73  ROI strip ratios
    roi_inset_ratio: float = 0.025
    roi_height_ratio: float = 0.25
    # image_filtering.py:24  fixed resize dim (unused downstream, kept for
    # interface parity with generate_regions)
    resize_dim: Tuple[int, int] = (300, 150)
    # image_filtering.py:105-110  ROI mask build constants
    roi_median_ksize: int = 9
    roi_dilate_n: int = 20

    # ----- classifier (--classify, models/classifier.py) ---------------------
    # segment_classification.py:18-24 preprocessing constants
    cnn_input_size: int = 224
    cnn_resize_to: int = 24
    cnn_mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    cnn_std: Tuple[float, float, float] = (0.229, 0.224, 0.225)
    # Per-window cap on segments routed through the CNN (padded batch).
    cnn_batch_cap: int = 64
    # Device-side preprocessing for the CNN; larger segments go to the host.
    cnn_device_preprocess: bool = True
    cnn_max_seg_hw: int = 64
    # Queue the CNN keep-mask with the device tracker's scan
    # (pipeline/classify_fused.py).
    classify_fused: bool = True

    # ----- execution ---------------------------------------------------------
    # Compute dtype of the IALM loop.  float32 is the shipped choice; the
    # reference runs float64 NumPy, and the tests use float64 on the CPU for
    # bit-accurate checks.
    rpca_dtype: str = "float32"
    # Batches the prefetch worker may read ahead of the device.
    prefetch_depth: int = 6
    # Windows per device dispatch.
    batch_windows: int = 16
    # Post-filter CUDA frames through the fused motion-filter kernel K1
    # (csrc/fused_motion.cu, bit-identical to the plain chain).  The name
    # is the JAX package's.
    use_pallas_postfilter: bool = True
    # Fuse the IALM E/M/Gram front into one pass: in the port, the CUDA
    # kernel K6 (csrc/ialm_front.cu) on a CUDA f32 solve.  Only read when
    # rpca_warm_basis is off: the warm solver never forms the
    # per-iteration Gram.  The name is the JAX package's.
    use_pallas_rpca: bool = True
    # Carry the row-space eigenbasis across IALM iterations (skips the
    # per-iteration Gram + eigh; the polish round re-converges the basis).
    # False selects the cold-start solver, which forms the Gram every
    # iteration (through K6 on the card).
    rpca_warm_basis: bool = True
    # Hold X as uint8 inside the solver: lossless for uint8 frames, so the
    # output is bit-identical.
    rpca_store_x_u8: bool = True
    # Round the loop-carried A/E/Y to bfloat16 between iterations.  Lossy:
    # iteration counts +-1 and motion within the +-2 u8 envelope of PARITY.md
    # deviation 8.  Applied only when rpca_dtype is float32.
    rpca_state_bf16: bool = True
    # Opt-in fixed-trip IALM: exactly this many iterations, no stopping test
    # and no freeze masks.  Bit-identical to the dynamic loop when every
    # window's dynamic count equals this value, divergent otherwise (a
    # window that would need more iterations is under-converged), so 0
    # keeps the reference's dynamic stopping (image_filtering.py:256-301).
    rpca_fixed_iters: int = 0
    # Opt-in native libjpeg decode of HDF5 sources straight to gray crops
    # (io/native.py:decode_window_gray), where the frame pump is built and
    # the frames are JPEG.
    native_decode: bool = False
    # Decode containers straight to gray crops on the av and parallel
    # backends (VideoFileSource.enable_gray_crop_stream), where libav is
    # built and its probes pass on the file.
    av_gray_decode: bool = True
    # ----- wire transport (io/wirecodec.py, io/prefetch.py) -----------------
    # Host->device transport of the gray window batches: "delta6" ships
    # bit-lossless predictive base-6 residuals, "delta4" fixed 4-bit
    # residuals, "auto" times three round trips of 2 MiB to the device and
    # back and engages delta6 when the best is below wire_auto_mbps (a
    # card's host link is far faster: raw ships there), anything else
    # ships raw u8.  Every packet is decoded on the device before
    # localisation.
    wire_codec: str = "auto"
    # Capacity of a batch's sparse escape stream (residuals the dense
    # levels cannot hold: moving birds, exposure steps); a batch that
    # overflows it ships raw.  delta4 scales it down for small batches.
    wire_escape_cap: int = 65536
    wire_auto_mbps: float = 1000.0
    # delta6's level-2 and level-3 streams are padded to buckets of these
    # quanta (smaller for small batches) that only grow, so few shapes ship.
    wire_lvl2_quantum: int = 131072
    wire_esc3_quantum: int = 4096
    # ----- device tracker (pipeline/tracking_device.py) ----------------------
    # Frames per step of the JAX package's scan; the port's device tracker
    # accepts it and gives the same results for any value.
    track_scan_chunk: int = 1
    # Enumeration LAP threshold of the device tracker; no effect on the host
    # tracker.
    track_enum_lap: int = 4
    # Stacked scatters/gathers in the JAX package's scan; the port accepts
    # it and gives the same results either way.
    track_stacked_ops: bool = False

    # ----- extensions beyond the reference ----------------------------------
    # Opt-in electronic image stabilisation (ops/stabilize.py): align each
    # frame to the gray crop of the ROI mask's frame by an integer-shift SAD
    # search over +-stabilize_max_shift pixels before RPCA.  0 (default)
    # keeps exact reference parity.
    stabilize_max_shift: int = 0


DEFAULT_CONFIG = PipelineConfig()

# The CLI's --accuracy-pack preset: the three opt-in extensions together.
# Kept as --set-style strings so explicit --set flags override them
# (config_with_overrides applies in order, later wins).
ACCURACY_PACK_OVERRIDES = (
    "angle_band_halfwidth=60",
    "false_angle_min_disp=5",
    "stabilize_max_shift=3",
)


def config_with_overrides(overrides, base: PipelineConfig = DEFAULT_CONFIG) -> PipelineConfig:
    """Apply "field=value" override strings (the CLI's --set flag).

    Values are parsed with the field's current type (bool accepts
    true/false/1/0; tuples accept comma-separated items)."""
    cfg = base
    for item in overrides:
        field, _, raw = item.partition("=")
        field = field.strip()
        if not hasattr(cfg, field):
            raise ValueError(f"unknown config field: {field!r}")
        current = getattr(cfg, field)
        if isinstance(current, bool):
            value = raw.strip().lower() in ("1", "true", "yes", "on")
        elif isinstance(current, int):
            value = int(raw)
        elif isinstance(current, float):
            value = float(raw)
        elif isinstance(current, tuple):
            elem = type(current[0])
            value = tuple(elem(v) for v in raw.split(","))
        else:
            value = raw
        cfg = dataclasses.replace(cfg, **{field: value})
    return cfg
