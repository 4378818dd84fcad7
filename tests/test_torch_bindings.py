"""The language bindings under bindings/ against the port's C header
(`stt_tpu_torch/native/stt_tpu.h`, the same ABI as stt_tpu's): every
`STT_*` function of the header is bound by each binding's source, and the
.NET error enum carries the header's codes by value."""

import re

import pytest

from test_bindings import BINDING_SOURCES
from test_torch_scorer import ROOT

HEADER = f"{ROOT}/stt_tpu_torch/native/stt_tpu.h"
CODE = re.compile(r"(STT_ERR_[A-Z_0-9]+)\s*=\s*(0x[0-9a-fA-F]+)")


def header_text() -> str:
    with open(HEADER) as f:
        return f.read()


def header_functions() -> list:
    return list(dict.fromkeys(re.findall(r"\b(STT_[A-Za-z0-9_]+)\s*\(", header_text())))


def codes(text: str) -> dict:
    return {name: int(value, 16) for name, value in CODE.findall(text)}


@pytest.mark.parametrize("name", sorted(BINDING_SOURCES))
def test_binding_covers_the_ports_c_surface(name):
    functions = header_functions()
    assert len(functions) >= 20, functions
    source = BINDING_SOURCES[name].read_text()
    assert [fn for fn in functions if fn not in source] == []


def test_dotnet_error_enum_matches_the_ports_header():
    header = codes(header_text())
    assert len(header) >= 20 and header["STT_ERR_OK"] == 0
    assert codes(BINDING_SOURCES["dotnet"].read_text()) == header
