"""The port's user scripts on the CPU at a tiny config
(``cld/simple_cifar10``): ``gddim_torch.scripts.sweep`` writes one record
a (NFE, order) pair whose samples are ``run_lib.sample_data``'s of the
same settings, and ``gddim_torch.scripts.check_int8_fidelity`` reports the
three variants and exits non-zero on a non-finite sample."""

import json

import numpy as np
import pytest
import torch

from gddim_torch import run_lib
from gddim_torch.checkpoints.manager import CheckpointManager
from gddim_torch.configs import get_config
from gddim_torch.scripts import check_int8_fidelity, sweep
from gddim_torch.train.state import create_train_state

CONFIG = "cld/simple_cifar10"
NFES, ORDERS = (3, 4), (0, 2)
SAMPLES, BATCH = 8, 4


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A run with snapshot 1: the config's initialisation, saved."""
    work = tmp_path_factory.mktemp("run")
    cfg = get_config(CONFIG)
    model = run_lib.init_model(cfg, "cpu")
    CheckpointManager(work).save_snapshot(1, create_train_state(cfg, model, torch.Generator()))
    return work


def small_corpus(name):
    """The config with the 512-image synthetic corpus (``data.is_partial``),
    so that each record's on-the-fly dataset statistics take seconds."""
    cfg = get_config(name)
    cfg.data.is_partial = True
    return cfg


def test_sweep_records_match_sample_data(run_dir, tmp_path, monkeypatch):
    monkeypatch.setattr(sweep, "get_config", small_corpus)
    out = tmp_path / "sweep"
    records = sweep.main(["--config", CONFIG, "--ckpt", "1", "--workdir", str(run_dir),
                          "--out", str(out), "--nfes", *map(str, NFES),
                          "--orders", *map(str, ORDERS), "--num_samples", str(SAMPLES),
                          "--batch_size", str(BATCH), "--device", "cpu"])
    lines = [json.loads(x) for x in (out / "sweep.jsonl").read_text().splitlines()]
    assert lines == records and len(records) == len(NFES) * len(ORDERS)
    for rec in records:
        assert rec["extractor"] == "proxy" and "fid_proxy" in rec and "fid" not in rec
        assert rec["n"] == SAMPLES and np.isfinite(rec["fid_proxy"])
        cfg = sweep.sweep_config(CONFIG, "deis", rec["nfe"], rec["order"], SAMPLES, BATCH)
        ref = tmp_path / f"ref_{rec['nfe']}_{rec['order']}"
        paths = run_lib.sample_data(cfg, "1", ref, run_dir, "cpu")
        got = out / f"deis_nfe{rec['nfe']}_order{rec['order']}"
        assert rec["nfe"] == int(np.load(paths[0])["nfe"])
        for path in paths:
            with np.load(path) as want, np.load(got / path.name) as have:
                for k in want.files:
                    np.testing.assert_array_equal(have[k], want[k], err_msg=f"{path.name}:{k}")


ARGS = ["--config", CONFIG, "--nfe", "3", "--batch", "4", "--rounds", "1", "--device", "cpu"]


def test_int8_fidelity_reports_three_variants(capsys):
    results = check_int8_fidelity.main(ARGS)
    assert set(results) == {"bf16_fused", "int8_dynamic", "int8_static"}
    for name in ("int8_dynamic", "int8_static"):
        rec = results[name]
        assert -1.0 <= rec["corr"] <= 1.0 and rec["max_abs_dx"] >= rec["mean_abs_dx"] >= 0
        assert np.isfinite(rec["proxy-FID"]) and np.isfinite(rec["proxy-FID_delta"])
        assert 0 <= rec["images"]["mean_abs_dx"] <= rec["images"]["max_abs_dx"] <= 1
    out = capsys.readouterr().out
    assert "bf16_fused proxy-FID" in out and "int8_static: pixel corr" in out


def test_int8_fidelity_refuses_non_finite_samples(monkeypatch):
    real = run_lib.build_sampling_fn

    def poisoned(config):
        fn = real(config)
        if config.model.conv_impl != "fused_int8":
            return fn

        def sample(*args, **kwargs):
            x, v, nfe = fn(*args, **kwargs)
            x = x.clone()
            x.view(-1)[0] = float("nan")
            return x, v, nfe

        return sample

    monkeypatch.setattr(run_lib, "build_sampling_fn", poisoned)
    with pytest.raises(SystemExit) as e:
        check_int8_fidelity.main(ARGS)
    assert e.value.code not in (0, None)
