"""``efficient_gnns_tpu_torch.parallel.dryrun`` and the launcher on CPU
worlds of gloo ranks: the dryrun completes on 4 ranks (every section) and on
3 (the two-level section skipped, saying so), its halo step's loss equal to
the single-device one; a rank that raises fails the world with its
traceback; what needs a card or a process group refuses without one."""

import pytest
import torch

from efficient_gnns_tpu_torch.parallel import make_mesh, run_world
from efficient_gnns_tpu_torch.parallel.dryrun import dryrun_multichip


def test_dryrun_on_four_ranks():
    r = dryrun_multichip(4, backend="gloo", device="cpu")
    assert r["halo2_loss"] == r["halo_loss"] and r["halo2_same_bits"]
    assert abs(r["halo_loss"] - r["single_device_loss"]) <= 1e-5 * abs(r["single_device_loss"])
    assert len(r["ranks"]) == 4 and all(x["mag_loss"] == r["mag_loss"] for x in r["ranks"])
    assert set(r["ms"]) == {"halo_step", "halo_exchange", "spmm_sharded", "spmm_halo",
                            "ring_nce", "halo2_step", "mag_epoch"}


def test_dryrun_on_an_odd_world_skips_the_two_level_section(capfd):
    r = dryrun_multichip(3, backend="gloo", device="cpu")
    assert r["halo2_loss"] is None and "halo2_step" not in r["ms"]
    assert "the two-level (2, 3/2) section is skipped" in capfd.readouterr().out


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
