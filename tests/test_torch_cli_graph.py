"""The port's command line against vg_tpu's, graph subcommands: one case
for each subcommand that builds, converts, edits or reports a graph or
its indexes, both CLIs on the same files (tests/cli_cases.py), standard
output and output files compared exactly (.npz bundles by their arrays).
Also the parsers: the same subcommands, options and defaults."""
import argparse

import pytest
import torch

import cli_cases
from vg_tpu.cli.main import build_parser as jax_parser
from vg_tpu_torch.cli.main import build_parser as torch_parser

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("VGTPU_PLATFORM", "cpu")


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_graph")
    p = cli_cases.build_fixture(d)
    return cli_cases.build_derived(d, p)


@pytest.mark.parametrize("argv,opts", [c[1:] for c in cli_cases.GRAPH_CASES],
                         ids=[c[0] for c in cli_cases.GRAPH_CASES])
def test_graph_subcommand_parity(fx, tmp_path, capsysbinary, argv, opts):
    cli_cases.run_case(capsysbinary, tmp_path, fx, argv, opts)


def _subparsers(ap):
    (action,) = [a for a in ap._actions
                 if isinstance(a, argparse._SubParsersAction)]
    return action.choices


def _options(sp):
    return [(tuple(a.option_strings), a.dest, a.default, a.required,
             a.nargs, tuple(a.choices or ()), getattr(a.type, "__name__",
                                                      a.type))
            for a in sp._actions]


def test_parser_subcommands_options_and_defaults_equal():
    want, got = _subparsers(jax_parser()), _subparsers(torch_parser())
    assert list(got) == list(want)
    assert len(want) >= 63
    for name in want:
        assert _options(got[name]) == _options(want[name]), name
    assert torch_parser().prog == "vg_tpu_torch"


def test_every_subcommand_has_a_parity_case():
    cases = (cli_cases.GRAPH_CASES + cli_cases.TOOL_CASES
             + cli_cases.MAP_CASES + cli_cases.MPMAP_CASES)
    first = {(argv if isinstance(argv, str) else argv[0]).split()[0]
             for _, argv, _ in cases}
    assert set(_subparsers(jax_parser())) - first == {"test"}


def test_test_subcommand_parses_alike():
    """`test` runs a test suite, so it is held by its parse only: the same
    arguments reach it, and the port's collects its own tests."""
    argv = ["test", "tests/test_torch_imports.py", "-x", "-q"]
    want = vars(jax_parser().parse_args(argv))
    got = vars(torch_parser().parse_args(argv))
    assert want.pop("func").__name__ == got.pop("func").__name__ == \
        "cmd_test"
    assert got == want == {"command": "test",
                           "pytest_args": argv[1:]}
