"""The port's twins of the JAX package's shell flows (scripts/*_torch.sh),
on the CPU with a stub `python` on PATH that records its argv and the two
environment variables the flows set, and runs nothing:

- each twin, given the JAX script's arguments, runs the port's CLIs with
  the JAX script's argv and environment (`train.py` read as
  `-m langsplat4d_torch.train`, and so on); with a trailing `--device cpu`
  it passes that on and nothing else changes;
- every recorded argv parses under the port CLI's own parser (render's
  config flags strictly), without training or rendering;
- chip_smoke.py's phase 24, which runs train_eval_torch.sh's flow through
  the train CLI's `main(argv)`, holds every flag of the twin's two phases,
  with the twin's values apart from the paths and the depth it cuts.
"""
import importlib.util
import json
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV_KEYS = ("language_feature_hiddendim", "use_discrete_lang_f")
STUB = f"""#!{sys.executable} -S
import json, os, sys
with open(os.environ["STUB_LOG"], "a") as f:
    f.write(json.dumps([sys.argv[1:], [os.environ.get(k) for k in
                                       {ENV_KEYS!r}]]) + "\\n")
"""
# the JAX script's entry -> the port's
ENTRY = {("train.py",): ["-m", "langsplat4d_torch.train"],
         ("render.py",): ["-m", "langsplat4d_torch.render"],
         ("eval.py",): ["-m", "langsplat4d_torch.eval"],
         ("-m", "langsplat4d.ae.train"): ["-m", "langsplat4d_torch.ae.train"],
         ("-m", "langsplat4d.ae.test"): ["-m", "langsplat4d_torch.ae.test"]}
FLOWS = {
    "train_eval": ["scenes/chicken", "chicken", "6"],
    "render-hypernerf": ["scenes/chicken", "chicken", "30000"],
    "render-neu3d": ["scenes/coffee", "coffee"],
    "eval-hypernerf": ["chicken", "30000", "annot/chicken", "ae/best.pth"],
    "eval-neu3d": ["coffee", "30000", "annot/coffee", "ae/best.pth"],
    "train_autoencoder": ["data/chicken", "chicken", "video"],
}


@pytest.fixture(scope="module")
def stub_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("stub")
    (d / "python").write_text(STUB)
    (d / "python").chmod(0o755)
    return d


def run_flow(script, args, stub_dir, work):
    """The calls of `python` that scripts/<script>.sh makes: [(argv,
    [the two environment variables])]."""
    log = work / f"{script}.{len(list(work.iterdir()))}.log"
    env = {k: v for k, v in os.environ.items() if k not in ENV_KEYS}
    env.update(PATH=f"{stub_dir}{os.pathsep}{env['PATH']}",
               STUB_LOG=str(log))
    subprocess.run(["bash", os.path.join(REPO, "scripts", f"{script}.sh"),
                    *args], cwd=work, env=env, check=True, timeout=60)
    return [json.loads(line) for line in log.read_text().splitlines()]


def ported(argv):
    for head, port in ENTRY.items():
        if tuple(argv[:len(head)]) == head:
            return port + argv[len(head):]
    raise AssertionError(f"no port of {argv[:2]}")


def parse_port(argv, env, monkeypatch):
    """argv (after `-m <module>`) through the port CLI's own parser, in the
    repo root (the flows name their configs from there), under the
    recorded environment."""
    module, rest = argv[1], argv[2:]
    monkeypatch.chdir(REPO)
    for k, v in zip(ENV_KEYS, env):
        if v is None:
            monkeypatch.delenv(k, raising=False)
        else:
            monkeypatch.setenv(k, v)
    if module == "langsplat4d_torch.train":
        from langsplat4d_torch.train.__main__ import parse_args
        args, cfg = parse_args(rest)
        return args.device, cfg
    if module == "langsplat4d_torch.render":
        from langsplat4d_torch.config import parse_cli
        from langsplat4d_torch.render.__main__ import parse_args
        args, cli = parse_args(rest)
        return args.device, parse_cli(cli, strict=True)
    if module == "langsplat4d_torch.eval":
        from langsplat4d_torch.eval.__main__ import parse_args
    elif module == "langsplat4d_torch.ae.train":
        from langsplat4d_torch.ae.train import parse_args
    else:
        assert module == "langsplat4d_torch.ae.test", module
        from langsplat4d_torch.ae.test import parse_args
    args = parse_args(rest)
    return args.device, args


@pytest.mark.parametrize("script", sorted(FLOWS))
def test_twin_passes_the_jax_flags(script, stub_dir, tmp_path, monkeypatch):
    args = FLOWS[script]
    jax_calls = run_flow(script, args, stub_dir, tmp_path)
    assert jax_calls, f"{script}.sh ran no python"
    want = [[ported(argv), env] for argv, env in jax_calls]
    assert run_flow(f"{script}_torch", args, stub_dir, tmp_path) == want
    on_cpu = run_flow(f"{script}_torch", args + ["--device", "cpu"],
                      stub_dir, tmp_path)
    assert on_cpu == [[argv + ["--device", "cpu"], env]
                      for argv, env in want]
    for (argv, env), (argv_cpu, _) in zip(want, on_cpu):
        assert parse_port(argv, env, monkeypatch)[0] is None
        device, parsed = parse_port(argv_cpu, env, monkeypatch)
        assert device == "cpu"
    if script == "train_eval":
        assert [env for _, env in want] == [["6", None], ["6", "t"]]
        assert parsed.runtime.language_feature_hiddendim == 6
        assert parsed.runtime.use_discrete_lang_f


def flag_values(argv):
    """{--flag: [its values]} of an argv of flags."""
    out, flag = {}, None
    for a in argv:
        if a.startswith("--"):
            flag = a
            out[flag] = []
        else:
            out[flag].append(a)
    return out


def test_phase_24_holds_the_twin_flags(stub_dir, tmp_path):
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    root = tmp_path / "scene"
    root.mkdir()
    _, cfg_file, base, _, argv_a, ckpt = smoke.cli_argv(
        torch.device("cuda"), str(root))
    argv_b = smoke.phase_b_argv(base, ckpt)
    (a, _), (b, _) = run_flow("train_eval_torch", FLOWS["train_eval"],
                              stub_dir, tmp_path)
    assert a[:2] == b[:2] == ["-m", "langsplat4d_torch.train"]
    a, b = flag_values(a[2:]), flag_values(b[2:])
    # the paths are phase 19's scene and an overlay of the same preset;
    # phase A's checkpoint iteration and so phase B's file are its depth
    paths = {"--source_path", "--expname", "--configs"}
    depth = {"--checkpoint_iterations", "--start_checkpoint"}
    for twin, smoke_argv in ((a, argv_a), (b, argv_b)):
        have = flag_values(smoke_argv)
        for flag, values in twin.items():
            assert flag in have, f"phase 24 lacks {flag}"
            if flag not in paths | depth:
                assert have[flag] == values, flag
    with open(cfg_file) as f:
        overlay = f.read()
    assert (f"_base_ = "
            f"{os.path.join(REPO, 'configs', 'hypernerf', 'default.py')!r}"
            in overlay)
    fb_last = flag_values(argv_a)["--checkpoint_iterations"][0]
    assert os.path.basename(flag_values(argv_b)["--start_checkpoint"][0]) \
        == f"chkpnt_fine-base_{fb_last}.pth"
    assert os.path.basename(b["--start_checkpoint"][0]) \
        == f"chkpnt_fine-base_{a['--checkpoint_iterations'][0]}.pth"
