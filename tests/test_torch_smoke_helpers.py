"""chip_smoke.py's helpers on the CPU (no card, no JAX).

The script's checks must not rest on torch.profiler: whether CUPTI
records the card's kernels depends on the machine. Here the helpers
that turn a profile into printed rows get profiles with no device
events, and the script's source is read to show that no check takes
what they return."""

import ast
import importlib.util
import pathlib
import types

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _event(key, device_type, us, count=1):
    return types.SimpleNamespace(key=key, device_type=device_type,
                                 self_device_time_total=us, count=count)


def test_profile_helpers_take_an_empty_profile(smoke, capsys):
    assert smoke.profile_rows([]) == []
    cpu_only = [_event("aten::add", torch.autograd.DeviceType.CPU, 0.0)]
    assert smoke.profile_rows(cpu_only) == []
    assert smoke.print_profile([], 12.5, "card") is None
    assert smoke.print_per_step("bounce step", [], 12.5, 0, "kernel",
                                "card") is None
    out = capsys.readouterr().out
    assert out.count("no device events recorded") == 2


def test_profile_helpers_print_device_rows(smoke, capsys):
    events = [_event("chain_bwd_kernel", torch.autograd.DeviceType.CUDA,
                     3000.0, 3),
              _event("aten::mul", torch.autograd.DeviceType.CPU, 0.0),
              _event("reduce_blocks_kernel", torch.autograd.DeviceType.CUDA,
                     1000.0, 6)]
    rows = smoke.profile_rows(events)
    assert rows == [("chain_bwd_kernel", 3.0, 3),
                    ("reduce_blocks_kernel", 1.0, 6)]
    smoke.print_profile(rows, 8.0, "card")
    smoke.print_per_step("step", rows, 8.0, 2, "chain_bwd", "card")
    out = capsys.readouterr().out
    assert "device busy 4.00 ms of 8.00 ms wall (50.0%)" in out
    assert "device busy 2.000 ms (chain_bwd 1.500 ms)" in out


def test_device_breakdown_without_device_events(smoke, capsys, monkeypatch):
    """A real profile on a machine where the profiler records no device
    events: the run goes on."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    rows, wall = smoke.device_breakdown(lambda: torch.ones(64) * 2.0, "card")
    assert rows == [] and wall >= 0.0
    assert "no device events recorded" in capsys.readouterr().out


def _names(node):
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def test_no_check_reads_the_profiler(smoke):
    """torch.profiler is used in device_breakdown alone, and no name bound
    from a profile helper's result reaches a check() call."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    helpers = {"device_breakdown", "profile_rows", "print_profile",
               "print_per_step"}
    profiled = set()
    for fn in ast.walk(tree):
        if not isinstance(fn, ast.FunctionDef):
            continue
        uses_profiler = any(
            isinstance(n, ast.Attribute) and n.attr == "profiler"
            for n in ast.walk(fn))
        if uses_profiler:
            profiled.add(fn.name)
        tainted = set()
        for node in ast.walk(fn):
            if (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Call)
                    and isinstance(node.value.func, ast.Name)
                    and node.value.func.id in helpers):
                for target in node.targets:
                    tainted |= _names(target)
        for node in ast.walk(fn):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                    and node.func.id == "check"):
                assert not _names(node) & tainted, (fn.name, ast.unparse(node))
                assert not _names(node) & helpers, (fn.name, ast.unparse(node))
    assert profiled == {"device_breakdown"}


def test_smoke_refuses_to_run_without_a_card(smoke, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert smoke.main() == 2
    out = capsys.readouterr()
    assert out.out == "" and "is_available" in out.err


def test_phases_print_tag_then_wall(smoke, capsys):
    phases = smoke.Phases()
    phases.start("C1", "first")
    phases.start("C2", "second")
    phases.end()
    phases.end()
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "[C1] first" and lines[1].startswith("  [C1] wall ")
    assert lines[2] == "[C2] second" and lines[3].startswith("  [C2] wall ")
    assert len(lines) == 4
