"""The port's serving CLI (``repro_torch.launch.serve``) against the JAX
package's (``repro/launch/serve.py``).

The JAX CLI's ``main()`` writes an MXINT8 anchor of a reduced smollm-135m
(and of a reduced mixtral-8x7b, the MoE family, and of a reduced rwkv6-7b,
served unbucketed) and serves it; the port's ``main()`` (argv patched,
in-process, on the CPU) serves the same directory with the same flags. The
printed ``req`` lines must be equal: the same prompts (numpy's seed 0),
the same greedy streams at mxint8 and mxint4. ``--no-reduced`` is accepted
(the reference's ``--reduced`` cannot be turned off). seamless-m4t-large-v2
is refused with the engine's ROADMAP C.12 error, where the JAX CLI fails
at its first admission with ``KeyError: 'frame_embeds'``.
"""
import sys

import pytest

from repro.launch import serve as jserve
from repro_torch.launch import serve


def _run(main, argv, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    main()
    out = capsys.readouterr().out.splitlines()
    return out, [line for line in out if line.startswith("req ")]


def _req_lines_equal(arch, fmt, tmp_path, capsys, monkeypatch):
    ckpt = str(tmp_path / "anchor")
    argv = ["--arch", arch, "--anchor-ckpt", ckpt,
            "--requests", "6", "--max-new", "5", "--slots", "2",
            "--fmt", fmt]
    out, want = _run(jserve.main, argv, capsys, monkeypatch)
    assert any(line.startswith("wrote anchor checkpoint") for line in out)
    out, got = _run(serve.main, argv + ["--device", "cpu"], capsys,
                    monkeypatch)
    assert out[0] == f"loaded anchor checkpoint {ckpt} (mxint8)"
    assert len(got) == 4 and all(f"fmt={fmt}" in line for line in got)
    assert got == want
    assert out[-1].startswith("engine: {")


@pytest.mark.parametrize("fmt", ["mxint8", "mxint4"])
def test_req_lines_equal_the_jax_cli(fmt, tmp_path, capsys, monkeypatch):
    _req_lines_equal("smollm-135m", fmt, tmp_path, capsys, monkeypatch)


@pytest.mark.parametrize("fmt", ["mxint8", "mxint4"])
def test_moe_req_lines_equal_the_jax_cli(fmt, tmp_path, capsys,
                                         monkeypatch):
    """The same with ``--arch mixtral-8x7b``: the MoE family."""
    _req_lines_equal("mixtral-8x7b", fmt, tmp_path, capsys, monkeypatch)


@pytest.mark.parametrize("fmt", ["mxint8", "mxint4"])
def test_rwkv_req_lines_equal_the_jax_cli(fmt, tmp_path, capsys,
                                          monkeypatch):
    """The same with ``--arch rwkv6-7b``: the RWKV family."""
    _req_lines_equal("rwkv6-7b", fmt, tmp_path, capsys, monkeypatch)


def test_encdec_is_refused(capsys, monkeypatch):
    argv = ["--arch", "seamless-m4t-large-v2", "--requests", "2",
            "--max-new", "2"]
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    with pytest.raises(KeyError, match="frame_embeds"):
        jserve.main()
    with pytest.raises(ValueError, match="C.12"):
        serve.main(argv + ["--device", "cpu"])


def test_makes_saves_and_reloads_its_own_anchor(tmp_path, capsys):
    ckpt = str(tmp_path / "anchor")
    argv = ["--arch", "starcoder2-3b", "--anchor-ckpt", ckpt,
            "--requests", "3", "--max-new", "3", "--device", "cpu"]
    serve.main(argv)
    first = capsys.readouterr().out.splitlines()
    assert first[0].startswith("wrote anchor checkpoint")
    serve.main(argv)
    again = capsys.readouterr().out.splitlines()
    assert again[0].startswith("loaded anchor checkpoint")
    assert [line for line in again if line.startswith("req ")] == \
        [line for line in first if line.startswith("req ")]
    # the load policy picks the anchor for an idle queue of 3
    assert all("fmt=mxint8" in line for line in first if
               line.startswith("req "))


def test_reduced_flag_turns_off(monkeypatch):
    """``--no-reduced`` asks for the published widths (stopped there: a
    full-width model is no CPU test)."""
    asked = []

    def published(arch):
        asked.append(arch)
        raise SystemExit(0)

    monkeypatch.setattr(serve, "get_config", published)
    with pytest.raises(SystemExit):
        serve.main(["--arch", "qwen2-72b", "--no-reduced", "--device", "cpu"])
    assert asked == ["qwen2-72b"]
    with pytest.raises(SystemExit):
        serve.main(["--arch", "no-such-arch", "--device", "cpu"])
