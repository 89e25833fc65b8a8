"""The SASS reader behind the chip runs' chain by count
(pcodec_tpu_torch/experiments/sass.py), on hand-written `cuobjdump -sass`
text: operands, loops, the compiler's latencies read from its schedule,
and the chain a pass."""

import os
import stat

import pytest

from pcodec_tpu_torch.experiments import sass


def ctrl(stall: int, scoreboard: bool = False) -> int:
    return (stall << sass.STALL_SHIFT) | ((0 if scoreboard else sass.NO_SCOREBOARD) << sass.WRITE_BARRIER_SHIFT)


@pytest.mark.parametrize("text,writes,reads", [
    ("IMAD.WIDE.U32 R4, R2, R3, R4", ["R4", "R5"], ["R2", "R3", "R4", "R5"]),
    ("IMAD.WIDE R4, R2, R3, R6", ["R4", "R5"], ["R2", "R3", "R6", "R7"]),
    ("@!P0 IADD3 R5, P1, PT, R6, R7, RZ", ["R5", "P1"], ["R6", "R7", "P0"]),
    ("IADD3.X R9, R8, R3, RZ, P1, !PT", ["R9"], ["R8", "R3", "P1"]),
    ("ISETP.GE.AND P0, PT, R5, RZ, PT", ["P0"], ["R5"]),
    ("SHFL.IDX PT, R7, R6, 0x1, 0x1f", ["R7"], ["R6"]),
    ("LDS.64 R4, [R2+0x8]", ["R4", "R5"], ["R2"]),
    ("STG.E.64 desc[UR4][R2.64], R4", [], ["UR4", "R2", "R3", "R4", "R5"]),
    ("SHF.R.U64 R4, R4, R6, R5", ["R4"], ["R4", "R6", "R5"]),
    ("LOP3.LUT P0, RZ, R2, 0x1, RZ, 0xc0, !PT", ["P0"], ["R2"]),
])
def test_sass_operands(text, writes, reads):
    ins = sass.parse(text, ctrl(4))
    assert (ins.writes, ins.reads, ins.stall, ins.scoreboard) == (writes, reads, 4, False)


# (text, stall, scoreboard): a loop whose R2 chain is IMAD -> IADD3 -> LOP3
# (4 + 5 + 2 cycles by the schedule's own distances), a shuffle off the chain
LOOP = [("MOV R1, c[0x0][0x28]", 2, False), ".L_x_0", ("IMAD R2, R2, R3, R4", 4, False),
        ("IADD3 R2, R2, 0x1, RZ", 5, False), ("LOP3.LUT R2, R2, 0xff, RZ, 0xc0, !PT", 1, False),
        ("SHFL.IDX PT, R5, R6, 0x1, 0x1f", 1, True), ("IADD3 R7, R5, R2, RZ", 1, False),
        ("ISETP.NE.AND P0, PT, R8, RZ, PT", 4, False), ("@P0 BRA `(.L_x_0)", 5, False), ("EXIT", 5, False)]


def sass_text(name="_ZN2c117conv1_warp_kernelILi6EEEvNS_5BasesEPKxix", body=LOOP) -> str:
    lines, addr = ["\tcode for sm_90a", f"\t\tFunction : {name}", '\t.headerflags\t@"EF_CUDA_SM90"'], 0
    for x in body:
        if isinstance(x, str):
            lines.append(f"{x}:")
            continue
        text, stall, sb = x
        lines.append(f"        /*{addr:04x}*/                   {text} ;          /* 0x000000000000{addr:04x} */")
        lines.append(f"                                                            /* 0x{ctrl(stall, sb):016x} */")
        addr += 16
    return "\n".join(lines) + "\n"


def test_sass_loop_latencies_and_chain():
    (name, (insts, labels)), = sass.functions(sass_text()).items()
    assert name.endswith("ILi6EEEvNS_5BasesEPKxix") and len(insts) == 9
    (body,) = sass.loops(insts, labels)
    assert [i.op for i in body][0] == "IMAD" and body[-1].op == "BRA" and len(body) == 7
    lat = sass.latencies(insts, labels)
    assert (lat["IMAD"], lat["IADD3"], lat["LOP3.LUT"]) == (4, 5, 2)
    c = sass.chain(body, lat)
    assert c == {"chain_cycles": 11, "chain_instructions": 3, "chain_variable": 0, "issue_cycles": 21,
                 "instructions": 7}


def test_sass_dump_finds_the_function_by_its_symbol(tmp_path):
    tool = tmp_path / "cuobjdump"
    text = tmp_path / "fn.sass"
    text.write_text(sass_text())
    tool.write_text("#!/bin/sh\n"
                    'if [ "$1" = -symbols ]; then echo "STT_FUNC STB_GLOBAL _ZN2c117conv1_warp_kernelILi6EEEvNS_5BasesEPKxix"; '
                    'elif [ "$3" = _ZN2c117conv1_warp_kernelILi6EEEvNS_5BasesEPKxix ]; then cat ' + str(text) + "; fi\n")
    tool.chmod(tool.stat().st_mode | stat.S_IEXEC)
    got = sass.dump(str(tool), os.devnull, "conv1_warp_kernelILi6E")
    assert "Function :" in got
    assert sass.dump(str(tool), os.devnull, "conv1_tile_kernelILi6E") == ""
    assert sass.dump(str(tmp_path / "missing"), os.devnull, "conv1_warp_kernelILi6E") == ""


def test_b1_chain_picks_the_loop_of_the_form():
    # 32 widening multiply-adds in the body make it the widening loop
    body = LOOP[:2] + [("IMAD.WIDE R10, R2, R3, R10", 4, False)] * 32 + LOOP[2:]
    text = sass_text(body=body)
    got = sass.b1_chain(text, "conv1_warp_kernelILi6E", "widening")
    assert got is not None and got["instructions"] == (7 + 32) / 32
    assert sass.b1_chain(text, "conv1_warp_kernelILi6E", "64bit") is None
    assert sass.b1_chain(text, "conv1_tile_kernelILi6E", "widening") is None


def test_sass_loop_is_the_natural_loop_not_the_span_as_written():
    # the R2 loop's latch lies after another loop: its body is its header
    # and its latch's block only; a diverged warp's fallback (reached by
    # BRA.DIV only) holds no loop of a pass
    body = [("MOV R1, c[0x0][0x28]", 2, False), ("@P2 BRA `(.L_x_1)", 5, False), ".L_x_0",
            ("IMAD R2, R2, R3, R4", 4, False),
            ("BRA `(.L_x_2)", 5, False), ".L_x_1", ("IADD3 R9, R9, 0x1, RZ", 4, False),
            ("@P1 BRA `(.L_x_1)", 5, False), ("EXIT", 5, False), ".L_x_2", ("IADD3 R2, R2, 0x1, RZ", 5, False),
            ("@P0 BRA `(.L_x_0)", 5, False), ("EXIT", 5, False), ".L_x_3", ("IADD3 R2, R2, 0x2, RZ", 5, False),
            ("BRA `(.L_x_3)", 5, False)]
    body.insert(3, ("BRA.DIV UR6, `(.L_x_3)", 5, False))
    (_, (insts, labels)), = sass.functions(sass_text(body=body)).items()
    got = sorted(tuple(i.op for i in b) for b in sass.loops(insts, labels))
    assert got == [("BRA.DIV", "IMAD", "BRA", "IADD3", "BRA"), ("IADD3", "BRA")]
