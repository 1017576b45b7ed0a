"""Model configuration: the port's own copy of the reference's dataclass
tree (casualhdrsplat_tpu/config.py), as far as it holds model settings.

Field names and defaults are the reference's, so a config dict written by
either package builds the same model.  Training, data and parallel
settings arrive with the slices that use them.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class RasterizeConfig:
    tile_h: int = 16
    tile_w: int = 128
    # Per-tile list capacity of the dense path (not ported yet; kept so
    # configs round-trip).
    tile_capacity: int = 1024
    # Max tiles a single Gaussian may be binned into (cap on bbox area).
    max_tiles_per_gaussian: int = 32
    # Depth-ordered window length of the streaming compositor.
    chunk: int = 128
    # Packed streaming compositor; the dense path (False) is not ported.
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
    # "auto" and "pallas" both select the packed kernel path in the port.
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


# --- the model half of the reference's config-ladder presets ---------------


def preset_1_single_frame() -> ModelConfig:
    """Single sharp LDR frame, fixed exposure, identity CRF."""
    cfg = ModelConfig()
    cfg.max_gaussians = 1 << 14
    cfg.num_virtual_views = 1
    cfg.optimize_poses = False
    cfg.optimize_exposure = False
    cfg.crf.kind = "identity"
    return cfg


def preset_2_multi_exposure() -> ModelConfig:
    """Static multi-exposure sequence: learnable CRF + exposures, no blur."""
    cfg = ModelConfig()
    cfg.num_virtual_views = 1
    cfg.optimize_poses = False
    cfg.optimize_exposure = True
    cfg.crf.kind = "mlp"
    return cfg


def preset_3_motion_blur() -> ModelConfig:
    """Motion blur only: spline trajectory + joint pose optimization."""
    cfg = ModelConfig()
    cfg.num_virtual_views = 8
    cfg.optimize_poses = True
    cfg.optimize_exposure = False
    cfg.crf.kind = "identity"
    return cfg


def preset_4_full() -> ModelConfig:
    """Full CasualHDRSplat: the default model."""
    return ModelConfig()


def preset_5_pod() -> ModelConfig:
    """The multi-host preset's model: ~3M Gaussians."""
    cfg = ModelConfig()
    cfg.max_gaussians = 3 << 20
    return cfg


PRESETS = {
    "ladder1": preset_1_single_frame,
    "ladder2": preset_2_multi_exposure,
    "ladder3": preset_3_motion_blur,
    "ladder4": preset_4_full,
    "ladder5": preset_5_pod,
    "default": ModelConfig,
}
