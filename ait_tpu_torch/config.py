"""Typed configuration tree (counterpart of ait_tpu/config.py).

The same frozen dataclass tree, with the same knob names, so the yaml
recipes in cfgs/*.yml load unchanged.  `Config.tpu` keeps its name and
fields: the port reads the canvas size, query size, ROI sampling ratio and
NMS tile from it, and ignores the TPU-only policy fields.  PyYAML is
imported only inside `Config.from_yaml`.
"""

from __future__ import annotations

import dataclasses
from ast import literal_eval
from dataclasses import dataclass, field
from typing import Any, Sequence, Tuple


@dataclass(frozen=True)
class TrainConfig:
    # Optimization (reference config.py:19-63)
    LEARNING_RATE: float = 0.001
    MOMENTUM: float = 0.9
    WEIGHT_DECAY: float = 0.0005
    GAMMA: float = 0.1
    STEPSIZE: Tuple[int, ...] = (30000,)
    DOUBLE_BIAS: bool = True
    BIAS_DECAY: bool = False
    TRUNCATED: bool = False
    MARGIN: float = -0.3  # margin-ranking loss margin (config.py:23)

    # Input (config.py:67-78)
    SCALES: Tuple[int, ...] = (600,)
    MAX_SIZE: int = 1000
    query_size: int = 128
    IMS_PER_BATCH: int = 1
    USE_FLIPPED: bool = True

    # ROI sampling (config.py:81-92)
    BATCH_SIZE: int = 128        # rois per image
    FG_FRACTION: float = 0.25
    FG_THRESH: float = 0.5
    BG_THRESH_HI: float = 0.5
    BG_THRESH_LO: float = 0.1

    # Box target normalization (config.py:117-124)
    BBOX_REG: bool = True
    BBOX_NORMALIZE_TARGETS_PRECOMPUTED: bool = True
    BBOX_INSIDE_WEIGHTS: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0)
    BBOX_NORMALIZE_MEANS: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.0)
    BBOX_NORMALIZE_STDS: Tuple[float, ...] = (0.1, 0.1, 0.2, 0.2)

    # RPN (config.py:134-161)
    HAS_RPN: bool = True
    RPN_POSITIVE_OVERLAP: float = 0.7
    RPN_NEGATIVE_OVERLAP: float = 0.3
    RPN_CLOBBER_POSITIVES: bool = False
    RPN_FG_FRACTION: float = 0.5
    RPN_BATCHSIZE: int = 256
    RPN_NMS_THRESH: float = 0.7
    RPN_PRE_NMS_TOP_N: int = 12000
    RPN_POST_NMS_TOP_N: int = 2000
    RPN_MIN_SIZE: int = 8
    RPN_BBOX_INSIDE_WEIGHTS: Tuple[float, ...] = (1.0, 1.0, 1.0, 1.0)
    RPN_POSITIVE_WEIGHT: float = -1.0
    USE_ALL_GT: bool = True

    PROPOSAL_METHOD: str = "gt"
    DISPLAY: int = 10
    SNAPSHOT_KEPT: int = 3


@dataclass(frozen=True)
class TestConfig:
    SCALES: Tuple[int, ...] = (600,)
    MAX_SIZE: int = 1000
    NMS: float = 0.3
    BBOX_REG: bool = True
    HAS_RPN: bool = True
    PROPOSAL_METHOD: str = "gt"
    RPN_NMS_THRESH: float = 0.7
    RPN_PRE_NMS_TOP_N: int = 6000
    RPN_POST_NMS_TOP_N: int = 300
    RPN_MIN_SIZE: int = 16
    MODE: str = "nms"
    # score threshold + per-image cap applied by the test CLI.  The
    # reference's live eval thresholds at 0.0 and only raises to 0.05 under
    # --vis (test_net_voc.py:311-313,424); 0.0 is therefore the default and
    # the CLI bumps it for visualization runs.
    SCORE_THRESH: float = 0.0
    MAX_PER_IMAGE: int = 100


@dataclass(frozen=True)
class ResnetConfig:
    FIXED_BLOCKS: int = 2  # kept for knob parity; live reference freezes stem+BN only
    MAX_POOL: bool = False


@dataclass(frozen=True)
class ModelConfig:
    """Architecture knobs (hardcoded in the reference ctors)."""
    backbone: str = "resnet50"          # resnet50 | resnet101 | vgg16
    channels: int = 1024                 # dout_base_model (resnet_sys:366)
    coattention: str = "mha"            # "mha" (VOC model) | "nonlocal" (COCO model)
    coatt_normalization: str = "division"   # nonlocal flavor: 'division' | 'softmax'
    # AIT transformer (faster_rcnn_sys:148-158)
    t_d_model: int = 512
    t_d_inner: int = 2048
    t_n_layers: int = 1
    t_n_head: int = 8
    t_d_k: int = 64
    t_d_v: int = 64
    t_n_position: int = 64
    t_dropout: float = 0.1
    t_causal_mask: bool = True   # system_mask ablation flips this to False
    t_attn_dist: str = "softmax"  # 'softmax' | 'division' (Modules.py:23-26)
    # SK block: the reference computes gate `a` but applies f*f (blocks:981).
    # 'faithful' reproduces f*f; 'fixed' applies the computed gate f*a.
    sk_gate: str = "faithful"
    class_agnostic: bool = True
    num_K: int = 3  # unused by the live path; kept for ctor parity
    # optional "contextual relation" recurrent-excitation branch
    # (resnet_sys_transformer_sk_dilat.py:234-241,277-354; off by default
    # there too).  rnn_method: 'GRU' | 'LSTM'.
    with_contextual_relation: bool = False
    rnn_method: str = "GRU"
    rnn_layers: int = 1
    rnn_reduction: int = 16
    rnn_bidirectional: bool = True


@dataclass(frozen=True)
class TpuConfig:
    """TPU/XLA-specific static-shape & precision policy (no reference analog)."""
    image_size: Tuple[int, int] = (608, 800)   # padded (H, W); 600-scale bucket
    query_hw: int = 128                        # == TRAIN.query_size
    max_gt_boxes: int = 20                     # MAX_NUM_GT_BOXES
    roi_sampling_ratio: int = 0                # <=0: reference's adaptive grid; >0: static
    nms_tile: int = 256                        # blocked-NMS tile size
    use_pallas_attention: bool = True          # fused attention kernel (eval)
    use_pallas_nms: bool = True                # Mosaic greedy-NMS sweep kernel
    input_uint8: bool = True                   # ship uint8, normalize on device
    host_s2d: bool = True                      # loader ships [H/2, W/2, 12] (resnet stem)
    portrait_bucket: bool = True               # transposed canvas for tall images
    # Wider static canvases for high-aspect images: the reference scales
    # shortest-side-600 with NO max clamp (blob.py:56-58 commented out), so a
    # fixed 608x800 canvas under-resolves images wider than ~4:3.  Each entry
    # is an extra (H, W) bucket; a record picks the FIRST canvas its
    # 600-scaled dims fit (base canvas, then these by ascending width;
    # transposed for portrait).  One bucket = one compiled program, batches
    # stay canvas-homogeneous.  (608, 1216) keeps every image up to 2:1 at
    # full reference resolution; beyond the widest bucket the scale is
    # capped.  Buckets whose height differs from image_size[0] are ignored
    # (a bucket only widens the canvas, it never changes the 600-scale
    # height), so overriding image_size for small experiments silently
    # disables the default bucket.
    wide_buckets: Tuple[Tuple[int, int], ...] = ((608, 1216),)
    compute_dtype: str = "bfloat16"            # conv/matmul dtype; params stay f32
    mesh_axes: Tuple[str, ...] = ("data",)
    donate_state: bool = True
    # Tensor parallelism over a 'model' mesh axis (Megatron-style): attention
    # heads and the FFN hidden dim of the AIT head + MHA co-attention are
    # computed shard-locally with explicit psum/pmax collectives.  Only
    # meaningful under parallel.make_sharded_train_step on a mesh that has
    # `tp_axis`; requires t_n_head % tp_size == 0 and t_d_inner % tp_size == 0.
    tp_size: int = 1
    tp_axis: str = "model"
    # Sequence parallelism over a 'seq' mesh axis (inference path): shards
    # the co-attention's image-token sequence — exact distributed softmax
    # for the directions that normalize over it (parallel/sp.py), row-
    # parallel + all-gather for the others.  For canvases whose image-token
    # activations outgrow one chip.  Only meaningful inside shard_map on a
    # mesh carrying `sp_axis` (e.g. make_mesh(n, axes=("data", "seq"))).
    sp_size: int = 1
    sp_axis: str = "seq"
    # Train-time decoder-prefix sharing in the AIT head: the decoder input is
    # the query tiled per proposal (Models.py:250), so its prefix (embed,
    # pos-enc glue, first self-attention) is per-image identical up to
    # dropout.  True (default) = run the prefix once per image; each image's
    # proposals then share its prefix dropout masks — the expected gradient
    # is unchanged (identical mask marginals, loss sums over proposals),
    # only the masking noise within an image correlates.  Priced at
    # -6.4 ms/step (-6.8%) on v5e; convergence smoke equal (PERFORMANCE.md).
    # False = reference-exact iid per-proposal masks.  Eval and any
    # dropout-free run are bitwise unaffected either way.
    dec_prefix_per_image: bool = True


@dataclass(frozen=True)
class Config:
    TRAIN: TrainConfig = field(default_factory=TrainConfig)
    TEST: TestConfig = field(default_factory=TestConfig)
    RESNET: ResnetConfig = field(default_factory=ResnetConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    tpu: TpuConfig = field(default_factory=TpuConfig)

    # Globals (config.py:252-310)
    train_categories: Tuple[int, ...] = (1,)
    test_categories: Tuple[int, ...] = (1,)
    PIXEL_MEANS: Tuple[float, ...] = (102.9801, 115.9465, 122.7717)
    RNG_SEED: int = 3
    EPS: float = 1e-14
    EXP_DIR: str = "default"
    POOLING_MODE: str = "align"   # shipped cfgs always set 'align'
    POOLING_SIZE: int = 7
    MAX_NUM_GT_BOXES: int = 20
    ANCHOR_SCALES: Tuple[int, ...] = (8, 16, 32)
    ANCHOR_RATIOS: Tuple[float, ...] = (0.5, 1.0, 2.0)
    FEAT_STRIDE: Tuple[int, ...] = (16,)

    # ------------------------------------------------------------------
    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def override(self, dotted: Sequence[str]) -> "Config":
        """Apply `--set`-style dotted-key overrides.

        e.g. ["TRAIN.RPN_PRE_NMS_TOP_N", "6000", "POOLING_MODE", "align"]
        Mirrors cfg_from_list (reference config.py:388-408) incl. type check.
        """
        assert len(dotted) % 2 == 0, "overrides must be key value pairs"
        cfg = self
        for key, raw in zip(dotted[0::2], dotted[1::2]):
            cfg = _set_dotted(cfg, key.split("."), raw)
        return cfg

    @classmethod
    def from_yaml(cls, path: str) -> "Config":
        """Merge a reference-format yaml recipe over the defaults.

        Mirrors cfg_from_file (reference config.py:345-386): unknown keys are
        an error, and value types must match the default's type.
        """
        import yaml

        with open(path) as f:
            doc = yaml.safe_load(f) or {}
        return _merge_into(cls(), doc)


def _coerce(raw: Any, old: Any) -> Any:
    if isinstance(raw, str):
        try:
            raw = literal_eval(raw)
        except (ValueError, SyntaxError):
            pass
    if isinstance(old, tuple) and isinstance(raw, (list, tuple)):
        return tuple(raw)
    if isinstance(old, bool):
        if isinstance(raw, bool):
            return raw
        raise TypeError(f"expected bool, got {raw!r}")
    if isinstance(old, float) and isinstance(raw, int):
        return float(raw)
    if old is not None and not isinstance(raw, type(old)):
        raise TypeError(f"type mismatch: {raw!r} vs default {old!r}")
    return raw


def _set_dotted(node: Any, keys: Sequence[str], raw: Any) -> Any:
    key = keys[0]
    if not hasattr(node, key):
        raise KeyError(f"unknown config key: {key}")
    old = getattr(node, key)
    if len(keys) == 1:
        return dataclasses.replace(node, **{key: _coerce(raw, old)})
    return dataclasses.replace(node, **{key: _set_dotted(old, keys[1:], raw)})


def _merge_into(node: Any, doc: dict) -> Any:
    updates = {}
    for key, val in doc.items():
        if not hasattr(node, key):
            # tolerate reference-only bookkeeping keys
            if key in ("SNAPSHOT_PREFIX", "EXP_DIR", "CROP_RESIZE_WITH_MAX_POOL",
                       "DISPLAY", "HAS_RPN"):
                continue
            raise KeyError(f"unknown config key in yaml: {key}")
        old = getattr(node, key)
        if dataclasses.is_dataclass(old) and isinstance(val, dict):
            updates[key] = _merge_into(old, val)
        else:
            updates[key] = _coerce(val, old)
    return dataclasses.replace(node, **updates)
