"""CLI entry point (cli.py) — end-to-end through main(argv)."""

import numpy as np
import pytest

from parallel_gcn.cli import main


def test_cli_trains_with_overrides(capsys, cora_like_dir):
    rc = main(["cora", "epochs=3", "early_stopping=0", "mode=eager",
               "backend=segment", "verbose=true", f"data_dir={cora_like_dir}"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "PARSING cora" in out
    assert "epoch=3 " in out  # three epoch lines printed
    assert "test_loss=" in out and "test_acc=" in out
    assert "epochs_run=3" in out


def test_cli_three_layer_residual(capsys, cora_like_dir):
    rc = main(["cora", "n_layers=3", "hidden_dims=16,16",
               "dropouts=0.2,0.2,0.2", "residual=true", "epochs=2",
               "early_stopping=0", "mode=eager", f"data_dir={cora_like_dir}"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "epochs_run=2" in out


def test_cli_no_args_prints_usage(capsys):
    assert main([]) == 2


def test_cli_malformed_argument_is_hard_error(capsys):
    rc = main(["cora", "epochs=2", "early_stopping=0", "mode=eager", "bogus"])
    assert rc == 2
    assert "malformed argument" in capsys.readouterr().out


def test_cli_typoed_value_is_hard_error(capsys, cora_like_dir):
    """epochs=10O (letter O) must NOT silently train the default epochs."""
    rc = main(["cora", "epochs=10O", "mode=eager", f"data_dir={cora_like_dir}"])
    assert rc == 2
    assert "not a valid int" in capsys.readouterr().out


def test_cli_unknown_key_is_hard_error(capsys, cora_like_dir):
    rc = main(["cora", "epocs=10", "mode=eager", f"data_dir={cora_like_dir}"])
    assert rc == 2
    assert "unknown config key" in capsys.readouterr().out


def test_cli_integral_float_override_coerces_to_int(capsys, cora_like_dir):
    """epochs=2.0 is accepted as the int 2 (coerced at parse time) — it must
    not reach range()/lax.scan as a float and crash deep in training."""
    rc = main(["cora", "epochs=2.0", "early_stopping=0", "mode=eager",
               "verbose=true", f"data_dir={cora_like_dir}"])
    assert rc == 0
    assert "epoch=2" in capsys.readouterr().out


def test_exec_config_validates_backend_and_reorder():
    """A typo'd layout knob (e.g. reorder='comunity') must raise, not silently
    run a different layout (ADVICE.md round 1)."""
    from parallel_gcn.config import ExecConfig

    with pytest.raises(ValueError, match="reorder"):
        ExecConfig(reorder="comunity")
    with pytest.raises(ValueError, match="backend"):
        ExecConfig(backend="dens")
    ExecConfig(reorder="community", backend="hybrid")  # valid values pass


def test_cli_checkpoint_and_resume(tmp_path, capsys, cora_like_dir):
    """checkpoint_dir/checkpoint_every are reachable from the CLI key=value
    surface, and resume_from restores the run."""
    import os

    ck = str(tmp_path / "ck")
    rc = main(["cora", "epochs=3", "early_stopping=0", "mode=eager",
               f"checkpoint_dir={ck}", "verbose=false",
               f"data_dir={cora_like_dir}"])
    assert rc == 0
    final = os.path.join(ck, "ckpt_final.npz")
    assert os.path.exists(final)
    rc = main(["cora", "epochs=5", "early_stopping=0", "mode=eager",
               f"resume_from={final}", "verbose=false",
               f"data_dir={cora_like_dir}"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "resumed from" in out or "epochs_run=2" in out


def test_cli_missing_dataset_is_an_error(capsys, tmp_path):
    rc = main(["cora", "epochs=1", f"data_dir={tmp_path}"])
    assert rc == 2
    assert "not found" in capsys.readouterr().out


def test_cli_more_devices_than_attached_is_an_error(capsys, cora_like_dir):
    """No virtual-mesh fallback: asking for more devices than JAX sees
    exits with an error before any data is read."""
    import jax

    n = len(jax.devices()) + 1
    rc = main(["cora", "epochs=1", f"n_devices={n}",
               f"data_dir={cora_like_dir}"])
    assert rc == 2
    out = capsys.readouterr().out
    assert "devices requested" in out and "PARSING" not in out
