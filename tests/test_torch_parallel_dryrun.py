"""``efficient_gnns_tpu_torch.parallel.dryrun`` and the launcher on CPU
worlds of gloo ranks: the dryrun completes on 4 ranks (every section) and on
3 (the GCN-KD section on a 1-D mesh; the SIGN dp x tp and two-level
sections skipped, saying so), its GCN-KD, SIGN and halo steps' losses equal
to the single-device ones; a rank that raises fails the world with its
traceback; what needs a card or a process group refuses without one."""

import numpy as np
import pytest
import torch

from efficient_gnns_tpu_torch.parallel import make_mesh, run_world
from efficient_gnns_tpu_torch.parallel.dryrun import dryrun_multichip


def test_dryrun_on_four_ranks():
    r = dryrun_multichip(4, backend="gloo", device="cpu")
    assert r["halo2_loss"] == r["halo_loss"] and r["halo2_same_bits"]
    assert abs(r["halo_loss"] - r["single_device_loss"]) <= 1e-5 * abs(r["single_device_loss"])
    assert len(r["ranks"]) == 4 and all(x["mag_loss"] == r["mag_loss"] for x in r["ranks"])
    assert set(r["ms"]) == {"gcn_kd_step", "gcn_kd_eval", "sign_step",
                            "halo_step", "halo_exchange", "spmm_sharded", "spmm_halo",
                            "ring_nce", "halo2_step", "mag_epoch"}
    # the last SIGN step's collectives, timed inside it, take part of it
    assert 0 < r["exchange_ms"]["sign_step"] < r["ms"]["sign_step"][-1]
    np.testing.assert_allclose(r["gcn_kd_losses"], r["single_gcn_kd_losses"], rtol=1e-5)
    np.testing.assert_allclose(r["sign_losses"], r["single_sign_losses"], rtol=1e-5)
    assert all(x["gcn_kd_digest"] == r["gcn_kd_digest"] for x in r["ranks"])
    assert all(x["sign_digest"]["replicated"] == r["sign_digest"]["replicated"]
               for x in r["ranks"])
    assert {x["sign_digest"]["split"][0] for x in r["ranks"]} == {0, 1}


def test_dryrun_on_an_odd_world_skips_the_two_level_section(capfd):
    r = dryrun_multichip(3, backend="gloo", device="cpu")
    assert r["halo2_loss"] is None and "halo2_step" not in r["ms"]
    assert r["sign_losses"] is None and "sign_step" not in r["ms"]
    np.testing.assert_allclose(r["gcn_kd_losses"], r["single_gcn_kd_losses"], rtol=1e-5)
    out = capfd.readouterr().out
    assert "the two-level (2, 3/2) section is skipped" in out
    assert "the SIGN dp x tp (3/2, 2) section is skipped" in out
    assert "SIGN dp x tp step loss skipped (odd world)" in out


def _raise_on_rank_one(device):
    if torch.distributed.get_rank() == 1:
        raise ValueError("rank one fails")
    return "done"


def test_a_rank_that_raises_fails_the_world():
    with pytest.raises(RuntimeError, match="rank 1 raised:(.|\n)*rank one fails"):
        run_world(_raise_on_rank_one, 2, backend="gloo", device="cpu")


def test_explicit_devices_and_backends():
    with pytest.raises(ValueError, match="initialised default process group"):
        make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="nccl backend needs device='cuda'"):
        run_world(_raise_on_rank_one, 2, backend="nccl", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(ValueError):
            run_world(_raise_on_rank_one, 2, backend="gloo", device="cuda")
