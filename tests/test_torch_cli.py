"""The port's CLI contract (MIGRATION.md): gmeta_tpu_torch/run/train.py
`main`'s parser against the JAX package's contract of
tests/test_cli_migration.py (its live reference flags, defaults and
dropped dead flags), and the port's Config fields, defaults and PRESETS
against gmeta_tpu/config.py, field by field."""

import contextlib
import dataclasses
import io

import pytest

from gmeta_tpu import config as jconfig
from gmeta_tpu_torch import config
from gmeta_tpu_torch.run import train as train_mod
from test_cli_migration import (DROPPED_DEAD_FLAGS, LIVE_REFERENCE_FLAGS,
                                _parse)


class _Parsed(Exception):
    def __init__(self, cfg):
        super().__init__("parsed")
        self.cfg = cfg


def _main_cfg(monkeypatch, argv):
    """The Config that the port's main() resolves from argv: main runs its
    parser, presets and validation, and stops where it would build the
    datasets."""
    def stop(cfg):
        raise _Parsed(cfg)
    monkeypatch.setattr(train_mod, "build_datasets", stop)
    with pytest.raises(_Parsed) as got:
        train_mod.main(list(argv) + ["--device", "cpu"])
    return got.value.cfg


# The port's own fields, after the JAX package's: the architecture
# (config.py `model` and the GAT's widths), which the JAX package lacks.
PORT_ONLY = [("arch", "str", "gcn"), ("gat_heads", "int", 4),
             ("gat_hidden", "int", 256), ("gat_out_heads", "int", 6),
             ("gat_out_dim", "int", 121), ("graphormer_layers", "int", 12),
             ("graphormer_hidden", "int", 80), ("graphormer_heads", "int", 8),
             ("graphormer_ffn", "int", 80)]


def _fields(cfg):
    """The values of the JAX package's Config fields; of a port Config,
    whose own fields must then hold their defaults."""
    if isinstance(cfg, config.Config):
        assert [(n, getattr(cfg, n)) for n, _, _ in PORT_ONLY] == \
            [(n, d) for n, _, d in PORT_ONLY]
    return {f.name: getattr(cfg, f.name)
            for f in dataclasses.fields(jconfig.Config)}


def test_reference_flags_are_counted():
    """The reference's argparse flags (G-Meta/train.py:152-177): 21 live
    ones and 4 dead ones dropped, as config.py's docstring states."""
    assert len(LIVE_REFERENCE_FLAGS) == 21 and len(DROPPED_DEAD_FLAGS) == 4
    assert not set(LIVE_REFERENCE_FLAGS) & set(DROPPED_DEAD_FLAGS)
    assert "21 live" in config.__doc__ and "4 dead" in config.__doc__


@pytest.mark.filterwarnings("ignore:n_way is ignored")
def test_every_live_reference_flag_parses_as_in_jax(monkeypatch):
    argv = []
    for k, v in LIVE_REFERENCE_FLAGS.items():
        argv += [f"--{k}", v]
    got = _fields(_main_cfg(monkeypatch, argv))
    assert got == _fields(_parse(argv))
    for k, v in LIVE_REFERENCE_FLAGS.items():
        assert str(got[k]) == v, k


def test_defaults_match_jax(monkeypatch):
    assert _fields(_main_cfg(monkeypatch, [])) == _fields(_parse([]))


@pytest.mark.filterwarnings("ignore:n_way is ignored")
@pytest.mark.parametrize("preset", sorted(jconfig.PRESETS))
def test_presets_parse_as_in_jax(monkeypatch, preset):
    argv = ["--preset", preset, "--hidden_dim", "32", "--task_mode", "True"]
    assert _fields(_main_cfg(monkeypatch, argv)) == _fields(_parse(argv))


@pytest.mark.parametrize("flag", DROPPED_DEAD_FLAGS + ["link_pred_mod"])
def test_dead_and_misspelled_flags_are_rejected(monkeypatch, flag):
    """The dead flags, and the reference README's `--link_pred_mod`, which
    worked there only by argparse's prefix matching, fail loudly."""
    with pytest.raises(SystemExit), contextlib.redirect_stderr(io.StringIO()):
        _main_cfg(monkeypatch, [f"--{flag}", "True"])


def test_help_lists_every_field_and_no_dead_flag():
    buf = io.StringIO()
    with pytest.raises(SystemExit), contextlib.redirect_stdout(buf):
        train_mod.main(["--help"])
    helptext = buf.getvalue()
    for f in dataclasses.fields(config.Config):
        assert f"--{f.name}" in helptext, f.name
    for extra in ("--preset", "--mesh_tasks", "--mesh_edges"):
        assert extra in helptext
    for flag in DROPPED_DEAD_FLAGS:
        assert f"--{flag}" not in helptext


def test_config_fields_match_jax():
    """Same field names in the same order, same types and defaults, then
    the port's own fields."""
    got = [(f.name, f.type, f.default)
           for f in dataclasses.fields(config.Config)]
    want = [(f.name, f.type, f.default)
            for f in dataclasses.fields(jconfig.Config)]
    assert got == want + PORT_ONLY


@pytest.mark.parametrize("preset", sorted(jconfig.PRESETS))
def test_config_presets_match_jax(preset):
    assert sorted(config.PRESETS) == sorted(jconfig.PRESETS)
    assert _fields(config.PRESETS[preset]) == _fields(
        jconfig.PRESETS[preset])
