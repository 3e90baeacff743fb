"""Config / flag system: argparse with `@file.cfg` argument files (port
of humor_tpu/utils/config.py: the train, test, fit and viz CLIs'
configs).

Each line of an @file holds whitespace-separated tokens ("--flag value"),
blank lines and "#" comments are skipped. A config is a dataclass whose
fields become flags: `foo_bar` -> `--foo-bar`, a bool -> `--foo-bar` /
`--no-foo-bar`, a tuple -> a `nargs="+"` list of its element type.
"""

from __future__ import annotations

import argparse
import dataclasses
import re
from dataclasses import dataclass, fields
from typing import List, Optional, Sequence, Tuple, Type, TypeVar

T = TypeVar("T")

NSTAGES = 3

class SplitLineParser(argparse.ArgumentParser):
    """fromfile parser: each line of an @file holds whitespace-separated
    tokens."""

    def __init__(self, *a, **kw):
        kw.setdefault("fromfile_prefix_chars", "@")
        super().__init__(*a, **kw)

    def convert_arg_line_to_args(self, arg_line: str) -> List[str]:
        line = arg_line.strip()
        if not line or line.startswith("#"):
            return []
        return line.split()


def _tuple_elem(f) -> type:
    """A tuple flag's element type: its default's first element's, else
    the annotation's (Tuple[str, ...] -> str), else float."""
    if f.default is not dataclasses.MISSING and len(f.default):
        return type(f.default[0])
    m = re.search(r"\[\s*(str|int|float)\b", str(f.type))
    return {"str": str, "int": int}.get(m.group(1), float) if m else float


def _add_dataclass_args(parser: argparse.ArgumentParser, cls: Type,
                        prefix: str = "") -> None:
    for f in fields(cls):
        name = f"--{prefix}{f.name.replace('_', '-')}"
        if f.type in ("bool", bool):
            default = (f.default if f.default is not dataclasses.MISSING
                       else False)
            group = parser.add_mutually_exclusive_group()
            group.add_argument(name, dest=f.name, action="store_true",
                               default=default)
            group.add_argument(
                f"--no-{prefix}{f.name.replace('_', '-')}",
                dest=f.name, action="store_false")
        elif (isinstance(f.default, (tuple, list))
              or "Tuple" in str(f.type) or "List" in str(f.type)):
            elem = _tuple_elem(f)
            parser.add_argument(name, dest=f.name, nargs="+", type=elem,
                                default=(list(f.default)
                                         if f.default is not dataclasses.MISSING
                                         else None))
        else:
            typ = (type(f.default)
                   if f.default is not dataclasses.MISSING
                   and f.default is not None else str)
            parser.add_argument(name, dest=f.name, type=typ,
                                default=(f.default
                                         if f.default is not dataclasses.MISSING
                                         else None))


def parse_into(cls: Type[T], argv: Optional[Sequence[str]] = None,
               prog: Optional[str] = None) -> T:
    """Parse argv (supporting @file.cfg) into a dataclass instance."""
    parser = SplitLineParser(prog=prog, allow_abbrev=False)
    _add_dataclass_args(parser, cls)
    ns = parser.parse_args(argv)
    kwargs = {}
    for f in fields(cls):
        v = getattr(ns, f.name)
        if isinstance(f.default, tuple) and isinstance(v, list):
            v = tuple(v)
        kwargs[f.name] = v
    return cls(**kwargs)


def _check_compute_dtype(name: str) -> None:
    """--model-compute-dtype: raises on a name the port does not take."""
    from humor_torch.ops.mlp import resolve_compute_dtype

    resolve_compute_dtype(name)


@dataclass
class TrainCLIConfig:
    # data
    data_path: str = "./data/amass_processed"
    train_datasets: Tuple[str, ...] = ()
    val_datasets: Tuple[str, ...] = ()
    batch_size: int = 200
    sample_num_frames: int = 10
    data_noise_std: float = 0.0
    # stage the training columns of the frame store in device memory and
    # gather batches there (data/device_store.py): 1 = on, 0 = off (host
    # gather, then a copy a batch), -1 = on when they fit a quarter of the
    # card's memory
    data_on_device: int = -1
    # model
    latent_size: int = 48
    in_rot_rep: str = "mat"
    out_rot_rep: str = "aa"
    model_data_config: str = "smpl+joints+contacts"
    conditional_prior: bool = True
    output_delta: bool = True
    # HuMoR-Qual: SMPL-forward joints fed back during scheduled sampling
    model_use_smpl_joint_inputs: bool = False
    # past-window length; the port runs 1 only
    model_steps_in: int = 1
    # the HuMoR MLPs' products: "bfloat16" (bf16 inputs, f32 accumulation
    # and outputs) or "" (f32)
    model_compute_dtype: str = ""
    # loss
    kl_loss: float = 0.0004
    kl_loss_anneal_start: int = 0
    kl_loss_anneal_end: int = 50
    contacts_loss: float = 0.01
    contacts_vel_loss: float = 0.01
    smpl_joint_loss: float = 1.0
    smpl_mesh_loss: float = 1.0
    smpl_joint_consistency_loss: float = 1.0
    # optimization
    out: str = "./out/humor_train"
    epochs: int = 200
    lr: float = 1e-4
    sched_milestones: Tuple[int, ...] = (50, 80, 140)
    sched_decays: Tuple[float, ...] = (0.5, 0.2, 0.4)
    sched_samp_start: int = 10
    sched_samp_end: int = 20
    val_every: int = 2
    save_every: int = 25
    print_every: int = 10
    # k steps a chunk (train/step.make_multi_steps): the chunk's batches
    # gathered at once, its stats read once; 0 = the trainer's auto k
    steps_per_dispatch: int = 0
    # batches built ahead of the steps by a daemon thread; 0: no thread
    prefetch_depth: int = 2
    ckpt: str = ""
    no_load_optim: bool = False
    steps_per_epoch: int = 200
    seed: int = 0
    # body model
    smplh_root: str = "./body_models/smplh"
    use_smpl_losses: bool = True
    # where training runs: the card unless "cpu" is asked for (raises
    # without a GPU)
    device: str = "cuda"
    # under torchrun (WORLD_SIZE > 1): the process group's backend; ""
    # is NCCL on the card and gloo on the CPU ("gloo" puts several ranks
    # on one card)
    dist_backend: str = ""

    def __post_init__(self):
        _check_compute_dtype(self.model_compute_dtype)


@dataclass
class TestCLIConfig:
    """Flags of the model-evaluation CLI (`python -m humor_torch.eval.cli`)."""

    data_path: str = "./data/amass_processed"
    test_datasets: Tuple[str, ...] = ()
    batch_size: int = 32
    ckpt: str = ""
    out: str = "./out/humor_test"
    eval_test: bool = False
    # the train or val split instead of test; with an empty
    # --test-datasets the split is the HuMoR paper's (data/amass.py)
    test_on_train: bool = False
    test_on_val: bool = False
    eval_sampling: bool = False
    qual: bool = False  # HuMoR-Qual: SMPL-joint feedback during rollout
    viz: bool = False   # render skeleton videos of the samples
    eval_recon: bool = False
    eval_sampling_len: float = 10.0  # seconds
    eval_num_samples: int = 1
    seed: int = 0
    smplh_root: str = "./body_models/smplh"
    # where the evaluation runs: the card unless "cpu" is asked for
    # (raises without a GPU)
    device: str = "cuda"


@dataclass
class FitCLIConfig:
    # data
    data_path: str = ""
    data_type: str = "AMASS"  # AMASS | PROX-RGB | PROX-RGBD | iMapper-RGB | RGB
    batch_size: int = 1
    seq_len: int = 60
    overlap_len: int = 10
    # RGB pipeline extras
    rgb_intrinsics: str = ""   # json [[fx,0,cx],[0,fy,cy],[0,0,1]]
    rgb_no_split: bool = False  # whole clip as ONE window
    mask_joints2d: bool = False
    mask_path: str = ""        # person-mask pngs for joint occlusion
    # PROX pseudo-GT SMPL fits (PROXD qualitative / MoSh quantitative):
    # loaded per frame and saved beside results as gt_results.npz for
    # `--mode prox` eval
    prox_load_fitting: bool = False
    prox_fitting_root: str = ""  # override the fittings/{mosh,proxd} walk
    # observation modalities
    amass_use_joints: bool = True
    amass_use_verts: bool = False
    amass_use_points: bool = False
    amass_noise_std: float = 0.0
    amass_make_partial: bool = False
    amass_partial_height: float = 0.9
    # models
    humor_ckpt: str = ""
    vposer_ckpt: str = ""
    init_motion_prior_ckpt: str = ""
    smplh_root: str = "./body_models/smplh"
    gt_body_type: str = "smplh"
    # "bfloat16" runs the HuMoR MLPs' products in bf16 with f32
    # accumulation and outputs (the stage-3 rollout then goes through the
    # typed rollout, not the f32 kernels); "" = float32
    model_compute_dtype: str = ""
    # optimization
    lr: float = 1.0
    num_iters: Tuple[int, ...] = (30, 80, 70)
    # multiplies every stage's iteration budget (and the stage-3 freeze
    # points); num_iters count single L-BFGS iterations
    num_iters_scale: int = 4
    lbfgs_max_iter: int = 20   # zoom probe budget (zoom search only)
    # "auto" (parallel below 12 windows, armijo from 12), "parallel"
    # (one batched value+grad of a step grid an iteration), "armijo"
    # (values of the grid, then one value+grad), "zoom" (sequential
    # strong-Wolfe), or "hybrid" (parallel, then a zoom polish tail)
    lbfgs_linesearch: str = "auto"
    # hybrid only: fraction of each stage's iterations run as the zoom
    # polish tail
    lbfgs_polish_frac: float = 0.08
    # parallel/armijo grid size; 0 = by window batch, clamp(128 // B, 4,
    # 16) (fitting/optimizer.resolve_candidates)
    lbfgs_candidates: int = 8
    # convergence early exit (torch LBFGS's tolerance_grad /
    # tolerance_change semantics, e.g. 1e-7 / 1e-9); 0 = off, the full
    # fixed budget
    lbfgs_tol_grad: float = 0.0
    lbfgs_tol_change: float = 0.0
    lbfgs_stall_patience: int = 3
    stage3_tune_init_num_frames: int = 15
    stage3_freeze_start: int = 30
    stage3_freeze_end: int = 55
    stage3_no_tune_init_state: bool = False
    stage3_contact_refine_only: bool = False
    # weights: one value per stage
    joint3d_weight: Tuple[float, ...] = (0.0, 0.0, 0.0)
    joint3d_rollout_weight: Tuple[float, ...] = (0.0, 0.0, 0.0)
    vert3d_weight: Tuple[float, ...] = (0.0, 0.0, 0.0)
    point3d_weight: Tuple[float, ...] = (0.0, 0.0, 0.0)
    joint2d_weight: Tuple[float, ...] = (0.0, 0.0, 0.0)
    pose_prior_weight: Tuple[float, ...] = (0.0, 0.0, 0.0)
    shape_prior_weight: Tuple[float, ...] = (0.0, 0.0, 0.0)
    motion_prior_weight: Tuple[float, ...] = (0.0, 0.0, 0.0)
    init_motion_prior_weight: Tuple[float, ...] = (0.0, 0.0, 0.0)
    joint_consistency_weight: Tuple[float, ...] = (0.0, 0.0, 0.0)
    bone_length_weight: Tuple[float, ...] = (0.0, 0.0, 0.0)
    joint3d_smooth_weight: Tuple[float, ...] = (0.0, 0.0, 0.0)
    contact_vel_weight: Tuple[float, ...] = (0.0, 0.0, 0.0)
    contact_height_weight: Tuple[float, ...] = (0.0, 0.0, 0.0)
    floor_reg_weight: Tuple[float, ...] = (0.0, 0.0, 0.0)
    rgb_overlap_consist_weight: Tuple[float, ...] = (0.0, 0.0, 0.0)
    # robustness
    robust_loss: str = "none"
    robust_tuning_const: float = 4.6851
    joint2d_sigma: float = 100.0
    # output
    out: str = "./out/humor_fit"
    save_results: bool = True
    save_stages_results: bool = False
    seed: int = 0
    # where the fit runs: the card unless "cpu" is asked for (raises
    # without a GPU)
    device: str = "cuda"

    def __post_init__(self):
        _check_compute_dtype(self.model_compute_dtype)

    def stage_weights(self):
        """-> 3 StageWeights from the per-stage weight lists."""
        from humor_torch.fitting.energies import StageWeights

        def w(name, i):
            vals = getattr(self, name)
            return float(vals[i]) if i < len(vals) else 0.0

        mapping = {
            "joints3d": "joint3d_weight",
            "joints3d_rollout": "joint3d_rollout_weight",
            "verts3d": "vert3d_weight",
            "points3d": "point3d_weight",
            "joints2d": "joint2d_weight",
            "pose_prior": "pose_prior_weight",
            "shape_prior": "shape_prior_weight",
            "motion_prior": "motion_prior_weight",
            "init_motion_prior": "init_motion_prior_weight",
            "joint_consistency": "joint_consistency_weight",
            "bone_length": "bone_length_weight",
            "joints3d_smooth": "joint3d_smooth_weight",
            "contact_vel": "contact_vel_weight",
            "contact_height": "contact_height_weight",
            "floor_reg": "floor_reg_weight",
            "rgb_overlap_consist": "rgb_overlap_consist_weight",
        }
        return tuple(
            StageWeights(**{k: w(v, i) for k, v in mapping.items()})
            for i in range(NSTAGES))


@dataclass
class VizCLIConfig:
    """Flags for the fit-result visualization CLI
    (`python -m humor_torch.viz.fitting`)."""

    # fitting output dir (the fit CLI's --out): holds final_results/ and
    # per-window <seq>/ result dirs
    results: str = ""
    out: str = "./out/humor_viz"
    # dir of the source video frames (sorted); blank canvas when absent
    frames: str = ""
    intrinsics: str = ""       # json [[fx,0,cx],[0,fy,cy],[0,0,1]]
    smplh_root: str = "./body_models/smplh"
    viz_final_only: bool = False   # skip the per-window sub-sequences
    viz_prior_frame: bool = False  # also render *_results_prior.npz
    viz_obs_2d: bool = False       # overlay observed OpenPose keypoints
    viz_no_mesh: bool = False      # skeleton overlays only
    max_frames: int = 120
    render_width: int = 1920
    render_height: int = 1080
    device: str = "cuda"       # where the meshes are skinned
