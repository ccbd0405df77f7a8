"""The port's training entry point, cli/train.main, on the CPU: a tiny
self-generated 3-D dataset, one epoch with m3d_v5's flags (full-gradient
unroll, the horizon curriculum, EMA, rollout selection, the reject guard),
then a resume from '<model>_lastEpoch' for one more epoch. The checkpoints'
mconf.json must load in both packages, and the resumed run must continue
from the saved params, optimizer state and step.
"""

import os

import numpy as np
import torch

from fluidnet_tpu.utils.checkpoint import load_mconf as j_load_mconf

from fluidnet_tpu_torch.cli.train import main
from fluidnet_tpu_torch.data.generate import generate_dataset
from fluidnet_tpu_torch.utils.checkpoint import STATE_FILE, load_mconf
from fluidnet_tpu_torch.utils.logger import read_log

from tests.torch_port_util import DEV


def _flags(root, epochs, resume):
    return ["-data_dir", str(root), "-dataset", "d3",
            "-model_dir", str(root / "models"), "-model_filename", "m",
            "-batch_size", "2", "-max_epochs", str(epochs), "-seed", "17",
            "-profile", "false", "-rollout_select_steps", "2",
            "-ema_decay", "0.999", "-horizon_schedule", "[[0,1,2],[1,2,2]]",
            "-load_model", resume, "-resume_training", resume,
            "-new_model.advection_method", "maccormackOurs",
            "-new_model.adaptive_window", "false",
            "-new_model.advection_window", "1",
            "-new_model.maccormack_strength", "0.75",
            "-new_model.train_buoyancy_prob", "0.5",
            "-new_model.train_vorticity_confinement_prob", "0.3",
            "-new_model.train_vorticity_confinement_amp", "3.0",
            "-new_model.long_term_grad_mode", "full",
            "-new_model.loss_reject_threshold", "100.0",
            "-new_model.optim.learning_rate", "0.0005",
            "--device", "cpu"]


def test_train_one_epoch_then_resume(tmp_path):
    generate_dataset(str(tmp_path / "d3"), n_tr=2, n_te=1, seed=5,
                     scenes_per_batch=2, size_xyz=(8, 8, 8), is_3d=True,
                     n_frames=4, save_every=2, max_iter=100, device=DEV)
    state, mconf = main(_flags(tmp_path, 1, "false"))
    models = tmp_path / "models"
    for d in ("m", "m_lastEpoch", "m_bestRollout", "m_ema"):
        assert (models / d / STATE_FILE).exists(), d
        assert load_mconf(str(models / d)) == mconf
        assert j_load_mconf(str(models / d)).long_term_grad_mode == "full"
    names, rows = read_log(str(models / "m_log.tsv"))
    assert names[:2] == ["epoch", "tr_loss"] and len(rows) == 1
    assert np.isfinite(rows[0]).all()
    step1 = state.step
    assert step1 == 2            # 4 samples, batch 2
    saved = torch.load(models / "m_lastEpoch" / STATE_FILE)
    assert saved["step"] == step1

    state2, _ = main(_flags(tmp_path, 2, "true"))
    _, rows = read_log(str(models / "m_log.tsv"))
    assert [r[0] for r in rows] == [0.0, 1.0]
    assert state2.step == 2 * step1
    # Every update accepted (threshold 100): Adam's count resumed too.
    assert int(state2.opt_state["count"]) == 2 * step1
    assert os.path.isfile(models / "m_conf.json")
