"""The port's one-command VOC parity run (``tpudet_torch/cli/parity.py``):
its dry run end to end on the CPU, as ``tests/test_cli.py`` runs
tpudet's, and every flag of ``tpudet.cli.parity``."""

import re

import pytest

from tpudet.cli import parity as jparity
from tpudet_torch.cli import parity


def flags(main, capsys):
    with pytest.raises(SystemExit):
        main(["--help"])
    return set(re.findall(r"(--[a-z][a-z-]*)", capsys.readouterr().out))


def test_parity_cli_keeps_every_flag(capsys):
    ref = flags(jparity.main, capsys)
    assert {"--data-dir", "--backbone-weights", "--dry-run",
            "--workdir"} <= ref
    assert ref <= flags(parity.main, capsys)


def test_parity_cli_dry_run(tmp_path, capsys):
    summary = parity.main([
        "--dry-run", "--workdir", str(tmp_path / "w"), "--steps", "4",
        "--batch-size", "8", "--eval-batch-size", "8", "--device", "cpu",
    ])
    assert "mAP" in summary
    assert (tmp_path / "w" / "checkpoints").exists()
    out = capsys.readouterr().out
    for stage in ("stage 2/4", "stage 3/4", "stage 4/4", "mAP@0.5"):
        assert stage in out


def test_parity_cli_checks_the_voc_layout(tmp_path):
    (tmp_path / "VOC2007" / "JPEGImages").mkdir(parents=True)
    with pytest.raises(SystemExit, match="missing"):
        parity.main(["--data-dir", str(tmp_path / "VOC2007"), "--workdir",
                     str(tmp_path / "w"), "--device", "cpu"])
    for sub in ("Annotations", "ImageSets"):
        (tmp_path / "VOC2007" / sub).mkdir()
    with pytest.raises(SystemExit, match="backbone weights not found"):
        parity.main(["--data-dir", str(tmp_path / "VOC2007"), "--workdir",
                     str(tmp_path / "w"), "--backbone-weights",
                     str(tmp_path / "none.npz"), "--device", "cpu"])
