"""Configuration surface of the PyTorch port.

The port's own copy of the JAX package's config (``ieagan_tpu/core/config.py``):
the reference's full config surface plus the framework's extensions, with the
same keys, defaults and merge semantics, so a config file loads unchanged in
either package. The port imports nothing from ``ieagan_tpu``; a test holds the
two ``DEFAULT_CONFIG`` dicts equal.

Merge semantics mirror the reference (``train.py:779-786``): JSON file first,
then explicit overrides on top.
"""

from __future__ import annotations

import copy
import json
from typing import Any, Mapping

# The reference defaults (reference: config.json:1-131). Keys and values are
# the public config API of the framework and must stay in sync with the
# reference so a user can switch with their existing config files.
DEFAULT_CONFIG: dict[str, Any] = {
    "num_workers": 8,
    "seed": 3651,
    "pin_memory": False,
    "shuffle": True,
    "augment": 0,
    "use_multiepoch_sampler": False,
    "debug": False,
    "model": "IEAGAN",
    "G_ch": 32,
    "G_param": "SN",
    "D_param": "SN",
    "D_ch": 32,
    "G_depth": 2,
    "D_depth": 2,
    "H_base": 3,
    "D_wide": True,
    "G_shared": True,
    "shared_dim": 128,
    "dim_z": 128,
    "z_var": 1.0,
    "hier": True,
    "cross_replica": False,
    "mybn": False,
    "G_activation": "inplace_relu",
    "D_activation": "inplace_relu",
    "G_attn": "0",
    "D_attn": "32",
    "norm_style": "bn",
    "G_init": "ortho",
    "D_init": "ortho",
    "skip_init": False,
    "G_lr": 5e-05,
    "D_lr": 5e-05,
    "G_B1": 0.0,
    "D_B1": 0.0,
    "G_B2": 0.999,
    "D_B2": 0.999,
    "batch_size": 40,
    "G_batch_size": 0,
    "num_G_accumulations": 1,
    "num_D_steps": 1,
    "num_D_accumulations": 1,
    "split_D": True,
    "num_epochs": 4,
    "parallel": False,
    "G_fp16": False,
    "D_fp16": False,
    "D_mixed_precision": False,
    "G_mixed_precision": False,
    "accumulate_stats": False,
    "num_standing_accumulations": 16,
    "G_eval_mode": True,
    "save_every": 1000,
    "test_every": 1000,
    "num_save_copies": 2,
    "num_best_copies": 2,
    "ema": True,
    "ema_decay": 0.9999,
    "use_ema": True,
    "ema_start": 10000,
    "adam_eps": 1e-06,
    "BN_eps": 1e-05,
    "SN_eps": 1e-06,
    "num_G_SVs": 1,
    "num_D_SVs": 1,
    "num_G_SV_itrs": 1,
    "num_D_SV_itrs": 1,
    "G_ortho": 0.0001,
    "D_ortho": 0.0,
    "toggle_grads": True,
    "logstyle": "%3.3e",
    "sv_log_interval": 10,
    "log_interval": 100,
    "resolution": 256,
    "n_classes": 40,
    "run_name": "BGd_2718",
    "resume": False,
    "latent_op": False,
    "latent_reg_weight": 300,
    "bottom_width": 4,
    "add_blur": False,
    "add_noise": True,
    "add_style": False,
    "conditional_strategy": "Contra",
    "hypersphere_dim": 1024,
    "pos_collected_numerator": False,
    "nonlinear_embed": False,
    "normalize_embed": True,
    "inv_stereographic": False,
    "contra_lambda": 1.0,
    "Angle": False,
    "angle_lambda": 1.0,
    "IEA_loss": True,
    "IEA_lambda": 1.0,
    "Uniformity_loss": True,
    "unif_lambda": 0.1,
    "diff_aug": True,
    "Con_reg": False,
    "cr_lambda": 10,
    "pixel_reg": False,
    "px_lambda": 1.0,
    "RRM_prx_G": True,
    "normalized_proxy_G": False,
    "RRM_prx_D": False,
    "RRM_embed": True,
    "n_head_G": 2,
    "n_head": 4,
    "rdof_dim": 4,
    "prior_embed": False,
    "attn_type": "sa",
    "sched_version": "default",
    "z_dist": "normal",
    "truncated_threshold": 1.0,
    "clip_norm": None,
    "amsgrad": False,
    "G_kernel_size": 3,
    "D_kernel_size": 3,
    "ada_belief": False,
    "pbar": "tqdm",
    "which_best": "FID",
    "stop_after": 100000,
    "trunc_z": 0.5,
    "denoise": False,
    "metric_log_name": "metric_log.jsonl",
    "reinitialize_metric_logs": False,
    "reinitialize_parameter_logs": False,
    "num_incep_images": 16000,
    "load_optim": True,
    # --- Framework extensions (defaults preserve reference behavior). Their
    # meaning is documented beside the same keys in ieagan_tpu/core/config.py;
    # the port reads use_pallas_attention (fused attention kernel on CUDA
    # tensors; False takes the plain composition everywhere).
    "events_per_batch": 1,
    "mesh": None,
    "compute_dtype": "bfloat16",
    "use_pallas_attention": True,
    "debug_batches": 8,
    "trace_dir": None,
    "trace_start": 10,
    "trace_steps": 5,
    "fid_dataset_name": "pxd_sim_test_com",
    "fid_gen_chunks": 8,
    "fid_trunc": 1.0,
    "fid_mode": "clean",
    "fid_backbone": "auto",
    "rrm_full_batch_sequence": False,
    "samples_per_class_sheet": 4,
    "remat": False,
    "remat_G": None,
    "remat_D": None,
    "replicate_G_step_bug": False,
    "fid_subprocess": True,
    "test_kid": False,
    "test_physics_events": 0,
    "fid_subprocess_timeout": 3600.0,
    "diff_aug_real": True,
    "temperature": 1.0,
    "diff_aug_policy": "color,translation,cutout",
    "device_transform": False,
}


def load_config(path: str | None = None, overrides: Mapping[str, Any] | None = None) -> dict:
    """Load config: defaults <- JSON file <- explicit overrides.

    Mirrors the reference's ``json.load`` + ``dict.update(vars(args))``
    (reference: train.py:779-786) but is tolerant of unknown keys (the
    reference swallows extras through ``**kwargs``; we keep them in the dict).
    """
    config = copy.deepcopy(DEFAULT_CONFIG)
    if path is not None:
        with open(path, "r", encoding="utf-8") as fp:
            config.update(json.load(fp))
    if overrides:
        config.update({k: v for k, v in overrides.items() if v is not None})
    return config


def event_size(config: Mapping[str, Any]) -> int:
    """The intra-event axis length (number of sensors = classes).

    The reference hardcodes 40 in several paths (reference: model.py:466,
    ieagan.py:1312, mycleanfid/fid.py:673, utils/dataloader.py:53); here
    everything derives from ``n_classes`` (quirk fix, SURVEY.md §2.4.4).
    """
    return int(config["n_classes"])
