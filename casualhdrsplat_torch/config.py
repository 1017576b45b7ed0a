"""Configuration: the port's own copy of the reference's dataclass tree
(casualhdrsplat_tpu/config.py).

Field names and defaults are the reference's, so a config dict written by
either package builds the same model and the same training run.  The
reference's ParallelConfig arrives with the multi-device slice; until then
`from_dict` refuses a dict that carries a `parallel` section, as it
refuses any unknown key.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass
class RasterizeConfig:
    tile_h: int = 16
    tile_w: int = 128
    # Per-tile list capacity of the dense path: a tile keeps its nearest
    # tile_capacity entries.  Must be a multiple of chunk.
    tile_capacity: int = 1024
    # Max tiles a single Gaussian may be binned into (cap on bbox area).
    max_tiles_per_gaussian: int = 32
    # Depth-ordered chunk length of both compositors (the early-stop vote
    # falls at its multiples).
    chunk: int = 128
    # True: the packed streaming compositor over one depth-sorted stream.
    # False: the dense path, a [tiles, tile_capacity] table per view
    # (ops/rasterize.py).
    packed: bool = True
    # Stream budget = stream_factor * N intersection slots per view; the
    # depth-sorted stream is waterfilled (far tails dropped) beyond it.
    stream_factor: int = 6
    near_plane: float = 0.05
    alpha_clip: float = 0.99
    alpha_threshold: float = 1.0 / 255.0
    # The compositor skips a tile's remaining windows once every pixel's
    # transmittance is below this.
    transmittance_eps: float = 1e-4
    # gsplat-style antialiased mode: opacity compensated by
    # sqrt(det(cov2d)/det(cov2d + blur)) (ops/projection.py).
    antialias: bool = False
    # Bin/sort once per frame at the views' mean position with
    # motion-inflated radii, instead of once per virtual view.  Exact up
    # to within-tile depth-order ties between views.
    shared_binning: bool = True
    # "auto" and "pallas" (the reference's name for its kernels) both select
    # the hand-written CUDA kernels of the path `packed` chooses; "xla"
    # asks for the dense path through the plain PyTorch compositor, on
    # whatever device the tensors are.
    backend: str = "auto"
    # In-kernel prefix choice of the TPU kernels; the port has one
    # compositor and ignores it (kept so configs round-trip).
    prefix: str = "cumsum"


@dataclass
class CRFConfig:
    """The mixture-of-sigmoids CRF is monotone by construction
    (models/crf.py)."""

    kind: str = "mlp"  # "identity" | "gamma" | "mlp"
    hidden: int = 32  # sigmoid units per channel
    gamma: float = 2.2
    # Pre-fit the learnable mixture to this gamma curve at create(); 0
    # keeps the clip(E)-shaped init.
    init_gamma: float = 2.2
    # Log-exposure normalization range fed to the MLP.
    log_min: float = -10.0
    log_max: float = 4.0


@dataclass
class ModelConfig:
    max_gaussians: int = 1 << 17
    sh_degree: int = 3
    # Number of virtual sharp images averaged into one blurred frame.
    num_virtual_views: int = 8
    spline_mode: str = "cubic"  # "linear" | "cubic"
    # log_exposures init to log(frac * median frame interval) when > 0.
    exposure_init_frac: float = 0.0
    # Trajectory control points per frame interval (1 = knot per frame).
    knots_per_frame: int = 1
    # Evaluate SH once at the exposure window's middle view and share it.
    sh_shared_view: bool = False
    optimize_poses: bool = True
    optimize_exposure: bool = True
    white_background: bool = False
    crf: CRFConfig = field(default_factory=CRFConfig)
    rasterize: RasterizeConfig = field(default_factory=RasterizeConfig)


@dataclass
class DensifyConfig:
    enabled: bool = True
    start_iter: int = 500
    stop_iter: int = 15_000
    interval: int = 100
    grad_threshold: float = 0.0002
    # World-space scale above which a high-grad Gaussian splits vs clones.
    split_scale_threshold_rel: float = 0.01  # relative to scene extent
    split_factor: float = 1.6
    prune_opacity: float = 0.005
    prune_screen_radius: float = 0.15  # fraction of image diagonal
    # Step from which the max-screen-radius prune activates; 0 = only
    # after the first opacity reset.  Set it for runs that disable opacity
    # resets, or oversized splats are never pruned.
    screen_prune_from: int = 0
    opacity_reset_interval: int = 3000
    sh_degree_interval: int = 1000
    # Sharded runs only (kept so configs round-trip).
    rebalance_threshold: float = 0.25


@dataclass
class OptimConfig:
    means_lr_init: float = 1.6e-4
    means_lr_final: float = 1.6e-6
    scales_lr: float = 5e-3
    quats_lr: float = 1e-3
    opacities_lr: float = 5e-2
    sh_dc_lr: float = 2.5e-3
    sh_rest_lr_div: float = 20.0
    pose_lr_init: float = 1e-3
    pose_lr_final: float = 1e-5
    # Steps with pose lr = 0 before the exp-decay schedule engages; the
    # decay is compressed into the remaining max_steps - warmup steps.
    pose_warmup_steps: int = 0
    # Multiplier on the translation half of every knot-delta update.
    pose_trans_lr_scale: float = 1.0
    # Adam beta1 of the pose group.  Knot gradients are sparse (one frame
    # per step touches about one spline support); b1 = 0 makes unsampled
    # knots hold still instead of coasting on stale momentum.
    pose_b1: float = 0.9
    # Restart the pose exp-decay clock at this step (0 = off): past it the
    # schedule is evaluated as if the warm-up had just ended.  Must be >
    # pose_warmup_steps.
    pose_lr_rewarm_step: int = 0
    exposure_lr: float = 1e-3
    # Adam beta1 of the per-frame exposure group (the same sparse-gradient
    # structure as the knots).
    exposure_b1: float = 0.9
    # The softplus-reparameterized mixture weights start near zero, so the
    # CRF needs a hotter lr than the other scalar groups.
    crf_lr: float = 5e-3
    max_steps: int = 30_000


@dataclass
class LossConfig:
    ssim_lambda: float = 0.2
    exposure_prior_weight: float = 1e-3
    crf_smoothness_weight: float = 1e-3
    # Cross-channel variance penalty on the CRF curve (crf.chroma_prior).
    crf_chroma_weight: float = 1e-2
    # Coarse-to-fine: blur render and target with a Gaussian whose sigma
    # anneals coarse_sigma0 -> 0 px over the first coarse_to_fine_steps
    # steps (losses.gaussian_blur); 0 disables.
    coarse_to_fine_steps: int = 0
    coarse_sigma0: float = 8.0
    # L2 anchor on the knot deltas: pins the trajectory to its SfM init
    # against a scene/spline co-warp the photometric loss cannot see.
    pose_anchor_weight: float = 0.0


@dataclass
class DataConfig:
    source: str = "synthetic"  # "synthetic" | "colmap" | "video"
    path: str = ""
    downscale: int = 1
    eval_every: int = 8  # every k-th frame held out


@dataclass
class TrainConfig:
    name: str = "casual-hdr-splat"
    seed: int = 0
    model: ModelConfig = field(default_factory=ModelConfig)
    densify: DensifyConfig = field(default_factory=DensifyConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    data: DataConfig = field(default_factory=DataConfig)
    log_every: int = 100
    eval_every: int = 1000
    checkpoint_every: int = 5000
    out_dir: str = "outputs"


def to_dict(cfg: TrainConfig) -> dict:
    """Plain-JSON form of the config tree."""
    return dataclasses.asdict(cfg)


def from_dict(d: dict) -> TrainConfig:
    """Inverse of to_dict.  Unknown keys raise (they signal a config of
    another version); missing keys keep their defaults."""

    def build(cls, sub):
        types = {f.name: f for f in dataclasses.fields(cls)}
        unknown = set(sub) - set(types)
        if unknown:
            raise ValueError(f"{cls.__name__}: unknown config keys {sorted(unknown)}")
        kw = {}
        for k, v in sub.items():
            default = types[k].default_factory() if (
                types[k].default_factory is not dataclasses.MISSING
            ) else types[k].default
            kw[k] = build(type(default), v) if dataclasses.is_dataclass(default) else v
        return cls(**kw)

    return build(TrainConfig, d)


# --- the reference's config-ladder presets ----------------------------------


def preset_1_single_frame() -> TrainConfig:
    """Single sharp LDR frame, fixed exposure, identity CRF."""
    cfg = TrainConfig(name="ladder1-single-frame")
    cfg.model.max_gaussians = 1 << 14
    cfg.model.num_virtual_views = 1
    cfg.model.optimize_poses = False
    cfg.model.optimize_exposure = False
    cfg.model.crf.kind = "identity"
    cfg.densify.enabled = False
    cfg.optim.max_steps = 1000
    return cfg


def preset_2_multi_exposure() -> TrainConfig:
    """Static multi-exposure sequence: learnable CRF + exposures, no blur."""
    cfg = TrainConfig(name="ladder2-multi-exposure")
    cfg.model.num_virtual_views = 1
    cfg.model.optimize_poses = False
    cfg.model.optimize_exposure = True
    cfg.model.crf.kind = "mlp"
    return cfg


def preset_3_motion_blur() -> TrainConfig:
    """Motion blur only: spline trajectory + joint pose optimization."""
    cfg = TrainConfig(name="ladder3-motion-blur")
    cfg.model.num_virtual_views = 8
    cfg.model.optimize_poses = True
    cfg.model.optimize_exposure = False
    cfg.model.crf.kind = "identity"
    return cfg


def preset_4_full() -> TrainConfig:
    """Full CasualHDRSplat: joint everything + densification."""
    return TrainConfig(name="ladder4-full")


def preset_5_pod() -> TrainConfig:
    """The multi-host preset: ~3M Gaussians (its mesh axes arrive with the
    multi-device slice)."""
    cfg = TrainConfig(name="ladder5-pod")
    cfg.model.max_gaussians = 3 << 20
    return cfg


PRESETS = {
    "ladder1": preset_1_single_frame,
    "ladder2": preset_2_multi_exposure,
    "ladder3": preset_3_motion_blur,
    "ladder4": preset_4_full,
    "ladder5": preset_5_pod,
    "default": TrainConfig,
}
