"""vitax_torch.config against vitax.config: the same 107 fields with the
same defaults, the same argv for the eight fields the port took last
(scan_blocks, scan_unroll, remat_window, profile_dir, profile_start_step,
profile_num_steps, arbiter_url, compile_cache_dir), and vitax's refusals
raised with vitax's messages; --scan_unroll other than 1 is the port's own
refusal (its eager step has no scan to unroll)."""

import dataclasses

import pytest

from vitax.config import Config as JaxConfig
from vitax.config import build_parser as jax_build_parser
from vitax_torch.config import Config, build_parser, config_fields_from_namespace

EIGHT = ("scan_blocks", "scan_unroll", "remat_window", "profile_dir", "profile_start_step", "profile_num_steps",
         "arbiter_url", "compile_cache_dir")


def test_same_fields_and_defaults():
    ours = {f.name: f.default for f in dataclasses.fields(Config)}
    theirs = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    assert len(theirs) == 107 and set(ours) == set(theirs)
    assert ours == theirs
    assert set(EIGHT) <= set(ours)


@pytest.mark.parametrize("argv", [
    [],
    ["--no_scan_blocks"],
    ["--scan_unroll", "1"],
    ["--remat_window", "2", "--num_blocks", "4"],
    ["--remat_window=4", "--num_blocks", "8", "--att_dropout", "0.1"],
    ["--profile_dir", "/tmp/p", "--profile_start_step", "0", "--profile_num_steps", "2"],
    ["--profile_dir=/tmp/q", "--profile_start_step=7"],
    ["--arbiter_url", "http://127.0.0.1:8200"],
    ["--compile_cache_dir", "/tmp/cache"],
    ["--no_scan_blocks", "--compile_cache_dir", "/c", "--arbiter_url", "http://a:1", "--profile_num_steps", "3"],
], ids=["defaults", "no_scan", "unroll1", "window2", "window4_drop", "profile", "profile_eq", "arbiter", "cache",
        "together"])
def test_eight_flags_parse_as_vitax(argv):
    ours, theirs = vars(build_parser().parse_args(argv)), vars(jax_build_parser().parse_args(argv))
    assert {k: ours[k] for k in EIGHT} == {k: theirs[k] for k in EIGHT}
    cfg = Config(**config_fields_from_namespace(build_parser().parse_args(argv))).validate()
    assert all(getattr(cfg, k) == theirs[k] for k in EIGHT)


REFUSALS = {
    "window_no_ckpt": dict(remat_window=2, num_blocks=4, grad_ckpt=False),
    "window_no_scan": dict(remat_window=2, num_blocks=4, scan_blocks=False),
    "window_divides": dict(remat_window=3, num_blocks=4),
    "window_and_unroll": dict(remat_window=2, num_blocks=4, scan_unroll=2),
    "window_pp": dict(remat_window=2, num_blocks=4, pp_size=2, fsdp_size=1),
    "unroll_zero": dict(scan_unroll=0),
    "pp_no_scan": dict(pp_size=2, num_blocks=4, fsdp_size=1, scan_blocks=False),
    "overlap_no_scan": dict(gather_overlap="on", scan_blocks=False),
    "profile_start": dict(profile_start_step=-1),
    "profile_num": dict(profile_num_steps=0),
}


@pytest.mark.parametrize("bad", list(REFUSALS.values()), ids=list(REFUSALS))
def test_refusals_name_vitax_message(bad):
    with pytest.raises(AssertionError) as theirs:
        JaxConfig(**bad).validate()
    with pytest.raises(ValueError) as ours:
        Config(**bad).validate()
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("unroll", [2, 4, 32])
def test_scan_unroll_past_one_refused(unroll, capsys):
    import vitax_torch.train.__main__ as train_main
    JaxConfig(scan_unroll=unroll).validate()          # vitax's XLA fusion knob
    with pytest.raises(ValueError, match="no scan to unroll"):
        Config(scan_unroll=unroll).validate()
    assert train_main.main(["--device", "cpu", "--scan_unroll", str(unroll)]) == 2     # the CLI's refusal
    assert "no scan to unroll" in capsys.readouterr().err


def test_remat_window_under_dots_attn_saveable_refused(capsys):
    import vitax_torch.train.__main__ as train_main
    argv = ["--remat_window", "2", "--num_blocks", "4", "--remat_policy", "dots_attn_saveable"]
    JaxConfig(remat_window=2, num_blocks=4, remat_policy="dots_attn_saveable").validate()     # vitax groups
    with pytest.raises(ValueError, match="no group of blocks"):
        Config(**config_fields_from_namespace(build_parser().parse_args(argv))).validate()
    assert train_main.main(["--device", "cpu", *argv]) == 2
    assert "no group of blocks" in capsys.readouterr().err


def test_train_cli_accepts_the_flags():
    argv = ["--profile_dir", "/tmp/p", "--profile_start_step", "1", "--profile_num_steps", "2", "--remat_window",
            "2", "--num_blocks", "4", "--compile_cache_dir", "/tmp/c", "--arbiter_url", "http://127.0.0.1:9"]
    cfg = Config(**config_fields_from_namespace(build_parser().parse_args(argv))).validate()
    assert (cfg.profile_dir, cfg.profile_start_step, cfg.profile_num_steps, cfg.remat_window, cfg.compile_cache_dir,
            cfg.arbiter_url) == ("/tmp/p", 1, 2, 2, "/tmp/c", "http://127.0.0.1:9")
    assert Config(**config_fields_from_namespace(build_parser().parse_args(["--no_scan_blocks"]))).scan_blocks is False
