"""The reference against the port at a tiny size on the CPU, seeded
weights: each number the check compares reads close to nought (bfloat16
products on both sides, rounded in other orders)."""
import portbench_tiny as tiny


def test_pairs_reference_agrees_with_the_port(tmp_path):
    f = tiny.files(tmp_path)
    rc, line = tiny.run_cell(f, "tiny.pairs", seed=2**31 + 11)
    assert rc == 0
    got = {k: c["value"] for k, c in line["checks"].items()}
    assert got["kp_count"] == 0
    assert got["kp_select"] < 0.01 and got["kp_missed"] < 0.01
    assert got["kp_loc_px"] < 0.1 and got["kp_score"] < 0.05
    assert got["desc_cos"] < 1e-4
    assert got["assign_p99"] < 1e-3 and got["match_rank"] < 1e-2


def test_train_reference_agrees_with_the_port(tmp_path):
    f = tiny.files(tmp_path)
    rc, line = tiny.run_cell(f, "tiny.train", seed=2**31 + 12)
    assert rc == 0
    got = {k: c["value"] for k, c in line["checks"].items()}
    assert got["loss_rel"] < 0.01
    assert all(v < 0.1 for k, v in got.items() if k != "loss_rel")
