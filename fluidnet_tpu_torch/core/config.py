"""Configuration: the conf / mconf split of the reference.

Port of fluidnet_tpu.core.config: `ModelConfig` (with InputChannels and
OptimConfig) is the model-owned config persisted with checkpoints (the
reference's `mconf`), `Config` the training-harness config (its `conf`,
default_conf.lua:22-162). The same field names, order and defaults, so a
`mconf.json` written by either package loads in the other, and the same
command-line overrides (`parse_args`, parse_args.lua: `--a.b.c value` for
any nested scalar, with the reference's camelCase aliases). Pure Python (no
torch), frozen and hashable.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class InputChannels:
    """Which fields feed the projection net (default_conf.lua:76-81)."""
    div: bool = True
    flags: bool = True
    p_div: bool = True
    u_div: bool = False


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    """mconf.optimState (default_conf.lua:108-119)."""
    learning_rate: float = 0.0025
    weight_decay: float = 0.0
    momentum: float = 0.9
    epsilon: float = 1e-4
    beta1: float = 0.9
    beta2: float = 0.999


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The reference mconf (default_conf.lua:44-153). See
    fluidnet_tpu.core.config.ModelConfig for what each field does."""
    # Simulation.
    dt: float = 0.1
    advection_method: str = "maccormack"   # euler|maccormack|*Ours
    advection_window: int = 2
    adaptive_window: bool = True
    maccormack_strength: float = 0.75
    buoyancy_scale: float = 0.0
    gravity_scale: float = 0.0
    vorticity_confinement_amp: float = 0.0
    gravity: Optional[Tuple[float, float, float]] = None
    sim_method: str = "convnet"            # convnet|jacobi|pcg
    max_iter: int = 100
    pcg_tol: float = 1e-4
    polish_iters: int = 0
    is_3d: bool = False

    # Model architecture.
    model_type: str = "default"            # default|tog|yang
    conv_compute_dtype: str = "bfloat16"   # bfloat16|float32
    input_channels: InputChannels = InputChannels()
    add_batch_norm: bool = False
    batch_norm_eps: float = 1e-4
    batch_norm_mom: float = 0.1
    batch_norm_affine: bool = True
    add_pressure_skip: bool = False
    nonlin_type: str = "relu"              # relu|relu6|sigmoid
    pool_type: str = "avg"                 # avg|max
    normalize_input: bool = True
    normalize_input_chan: str = "UDiv"     # UDiv|pDiv|div
    normalize_input_func: str = "std"      # std|norm
    normalize_input_threshold: float = 1e-5
    banks_num: int = 1
    banks_split_stage: int = 1
    banks_join_stage: int = 3
    banks_type: str = "mres"               # mres|dilate
    banks_aggregate_method: str = "concat"  # concat|add
    banks_weight_share: bool = False

    # Losses (default_conf.lua:82-98).
    loss_p_lambda: float = 0.0
    loss_u_lambda: float = 0.0
    loss_div_lambda: float = 1.0
    loss_func_border_weight: float = 4.0
    loss_func_border_width: int = 3
    long_term_div_lambda: float = 1.0
    long_term_div_num_steps: Tuple[int, int] = (4, 16)
    long_term_div_probability: float = 0.9
    long_term_grad_mode: str = "last"      # last|full

    # Training-time randomization (default_conf.lua:127-149).
    time_scale_sigma: float = 1.0
    train_buoyancy_prob: float = 0.0
    train_buoyancy_scale: float = 2.0
    train_gravity_prob: float = 0.0
    train_gravity_scale: float = 2.0
    train_vorticity_confinement_prob: float = 0.0
    train_vorticity_confinement_amp: float = 2.0
    train_target_source: str = "manta"     # manta|jacobi|pcg
    augment_without_targets: bool = False

    grad_norm_threshold: float = 1.0
    loss_reject_threshold: float = 0.0
    optimization_method: str = "adam"
    optim: OptimConfig = OptimConfig()

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class Config:
    """The reference conf (default_conf.lua:22-162). See
    fluidnet_tpu.core.config.Config for what each field does. The port
    adds `device`: where training runs, the CUDA device unless "cpu" is
    asked for."""
    batch_size: int = 16
    data_dir: str = "data/datasets"
    dataset: str = "gen2d_default"
    eval_during_training: bool = True
    ignore_frames: int = 0
    load_model: bool = False
    max_epochs: int = 5000
    max_samples_per_epoch: int = 0         # 0 == unlimited (lua math.huge)
    model_dir: str = "data/models"
    model_filename: str = "conv_model"
    num_data_threads: int = 8
    device_data_cache: bool = True
    device_data_cache_max_gb: float = 8.0
    epoch_scan: bool = True
    profile: bool = True
    resume_training: bool = False
    rollout_select_steps: int = 24
    train: bool = True
    seed: int = 1
    lr_epoch_mults: Tuple[Tuple[int, float], ...] = ()
    ema_decay: float = 0.0
    horizon_schedule: Tuple[Tuple[int, int, int], ...] = ()
    max_host_rss_gb: float = 0.0
    max_wall_s: float = 0.0
    new_model: ModelConfig = ModelConfig()
    device: str = "cuda"

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


# --- CLI overrides (parse_args.lua equivalent) -------------------------------

_SNAKE = {
    # The reference's camelCase flag names, accepted as aliases.
    "batchSize": "batch_size", "dataDir": "data_dir",
    "modelDir": "model_dir", "modelFilename": "model_filename",
    "loadModel": "load_model", "resumeTraining": "resume_training",
    "maxEpochs": "max_epochs", "numDataThreads": "num_data_threads",
    "newModel": "new_model", "advectionMethod": "advection_method",
    "maccormackStrength": "maccormack_strength",
    "buoyancyScale": "buoyancy_scale", "gravityScale": "gravity_scale",
    "vorticityConfinementAmp": "vorticity_confinement_amp",
    "simMethod": "sim_method", "maxIter": "max_iter", "pTol": "pcg_tol",
    "modelType": "model_type", "addBatchNorm": "add_batch_norm",
    "addPressureSkip": "add_pressure_skip", "nonlinType": "nonlin_type",
    "poolType": "pool_type", "normalizeInput": "normalize_input",
    "banksNum": "banks_num", "banksSplitStage": "banks_split_stage",
    "banksJoinStage": "banks_join_stage", "banksType": "banks_type",
    "banksAggregateMethod": "banks_aggregate_method",
    "banksWeightShare": "banks_weight_share",
    "lossPLambda": "loss_p_lambda", "lossULambda": "loss_u_lambda",
    "lossDivLambda": "loss_div_lambda",
    "longTermDivLambda": "long_term_div_lambda",
    "longTermDivProbability": "long_term_div_probability",
    "timeScaleSigma": "time_scale_sigma",
    "trainTargetSource": "train_target_source",
    "gradNormThreshold": "grad_norm_threshold",
    "inputChannels": "input_channels", "pDiv": "p_div", "UDiv": "u_div",
}


def _parse_value(old, raw: str):
    """Typed parse against the existing field value (parse_args.lua:82-201
    does the same type checking)."""
    if isinstance(old, bool):
        if raw.lower() in ("true", "1", "yes"):
            return True
        if raw.lower() in ("false", "0", "no"):
            return False
        raise ValueError(f"expected bool, got {raw!r}")
    if isinstance(old, int):
        return int(raw)
    if isinstance(old, float):
        return float(raw)
    if isinstance(old, str):
        return raw
    if isinstance(old, tuple) or old is None:
        return tuple(json.loads(raw)) if raw.startswith("[") \
            else json.loads(raw)
    raise ValueError(f"cannot override field of type {type(old)}")


def _set_path(obj, path, raw):
    head = _SNAKE.get(path[0], path[0])
    if not hasattr(obj, head):
        raise KeyError(f"unknown config field: {head}")
    old = getattr(obj, head)
    if len(path) == 1:
        return dataclasses.replace(obj, **{head: _parse_value(old, raw)})
    return dataclasses.replace(obj, **{head: _set_path(old, path[1:], raw)})


def parse_args(conf: Config, argv) -> Config:
    """Applies `--a.b.c value` (or `-a.b.c value`) overrides to conf, type
    checked against the defaults (torch.parseArgs, parse_args.lua)."""
    i = 0
    argv = list(argv)
    while i < len(argv):
        arg = argv[i]
        if not arg.startswith("-"):
            raise ValueError(f"expected -key, got {arg!r}")
        key = arg.lstrip("-")
        if key in ("help", "h"):
            print(json.dumps(to_dict(conf), indent=2))
            raise SystemExit(0)
        if i + 1 >= len(argv):
            raise ValueError(f"missing value for {arg}")
        conf = _set_path(conf, key.split("."), argv[i + 1])
        i += 2
    return conf


def save_parameters(conf: Config, path: str):
    """Human-readable conf dump (save_parameters.lua:69 equivalent)."""
    with open(path, "w") as f:
        json.dump(to_dict(conf), f, indent=2, sort_keys=True)


def default_conf() -> Config:
    return Config()


def from_dict(d) -> ModelConfig:
    """A ModelConfig from its JSON dict form (the "mconf" entry of a
    checkpoint's mconf.json): nested configs rebuilt, lists as tuples."""
    d = dict(d)
    d["input_channels"] = InputChannels(**d["input_channels"])
    d["optim"] = OptimConfig(**d["optim"])
    for k, v in list(d.items()):
        if isinstance(v, list):
            d[k] = tuple(v)
    return ModelConfig(**d)


def to_dict(obj):
    if dataclasses.is_dataclass(obj):
        return {f.name: to_dict(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, tuple):
        return [to_dict(x) for x in obj]
    return obj
