"""The port's quickstart (``repro_torch.examples.quickstart``) on the CPU:
every registered path against its own reference at its tolerance (the
kernel paths through their plain versions), the Fig. 8 counts and the
tracks_128 whole-network run, each printed ``ok``."""

import pytest
import torch

from repro_torch.core import paths
from repro_torch.examples import quickstart


def test_quickstart_prints_ok_for_every_path(capsys):
    assert quickstart.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    verdicts = {line.split()[0]: line.split()[-1] for line in out.splitlines()
                if " vs ref: " in line}
    assert set(verdicts) == set(paths.available())
    assert set(verdicts.values()) == {"ok"}
    assert "MMM3 adds 208,560 -> 6,960" in out
    tracks = [line for line in out.splitlines()
              if line.startswith("tracks128")]
    assert len(tracks) == 1 and tracks[0].endswith(" ok")


def test_quickstart_raises_without_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        quickstart.main([])
