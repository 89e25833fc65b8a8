"""A kernel's loops read from `cuobjdump -sass`, and their dependent chain
by count: the least time a serial loop can take, whatever else it issues.

A loop is the natural loop of a backward branch: the blocks that reach
the branch without passing its target, a pass in reverse postorder (an
inner loop's body counted once). Its chain: the body's
instructions issued as soon as the registers and predicates they read
are ready, passes of the body chained through what they carry, and the
growth of a pass once steady. A fixed-latency instruction's result is
ready after the compiler's own latency for its opcode: the fewest cycles
its schedule puts, anywhere in the function and inside one basic block,
between such an instruction and the first that reads that result. A
variable-latency one (it writes through a scoreboard: a load, a shuffle)
counts its issue stall only, so the count stays a least time; the chain
says how many of those it holds. Beside it, the issue stall cycles: the
sum of the body's stall fields, its least issue time on one warp.

Used by chip_smoke.py and tools/torch_kernel_variants.py on the card's
builds; the parsing runs anywhere (tests/test_torch_sass.py).
"""

import re
import subprocess
from dataclasses import dataclass, field

STALL_SHIFT = 41  # the control word (the second 64-bit word): stall cycles in bits 41-44
WRITE_BARRIER_SHIFT = 46  # its write scoreboard in bits 46-48, 7 for none
NO_SCOREBOARD = 7
PASSES = 8  # passes chained; the growth is read over the second half
NO_DEST = {"ST", "STS", "STG", "STL", "STSM", "RED", "BRA", "BRX", "JMP", "JMX", "EXIT", "RET", "CALL", "BAR",
           "BSSY", "BSYNC", "BREAK", "WARPSYNC", "NOP", "MEMBAR", "DEPBAR", "LDGDEPBAR", "YIELD", "CCTL", "ERRBAR",
           "BPT", "KILL"}
ENDS_BLOCK = {"BRA", "BRX", "JMP", "JMX", "EXIT", "RET", "CALL", "BAR", "BSYNC", "WARPSYNC", "BREAK"}
_INST = re.compile(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;?\s*/\* 0x[0-9a-f]{16} \*/")
_CTRL = re.compile(r"\s*/\* 0x([0-9a-f]{16}) \*/\s*$")
_REG = re.compile(r"(?<![\w.])!?(U?R\d+|U?P\d+)\b(\.64)?")
_PRED = re.compile(r"!?U?P(?:\d+|T)$")


@dataclass
class Inst:
    addr: int
    op: str  # opcode and modifiers
    reads: list = field(default_factory=list)
    writes: list = field(default_factory=list)
    stall: int = 0
    scoreboard: bool = False  # its result waited on through a scoreboard (variable latency)
    guarded: bool = False
    target: object = None  # a branch's target: an address, or a label's name until resolved


def _regs(token: str, pair: bool) -> list:
    """The registers an operand names (a pair for a 64-bit one; RZ, PT none)."""
    out = []
    for m in _REG.finditer(token):
        r = m.group(1)
        out.append(r)
        if (pair or m.group(2)) and "R" in r:
            out.append(re.sub(r"\d+$", lambda d: str(int(d.group()) + 1), r))
    return out


def parse(text: str, hi: int, addr: int = 0) -> Inst:
    """One instruction from its text (`@!P0 IMAD.WIDE R4, R2, R3, R4`) and
    its control word."""
    guard = re.match(r"@(!?U?P\w+)\s+", text)
    body = text[guard.end():] if guard else text
    op, _, rest = body.partition(" ")
    ops = [o.strip() for o in rest.split(",")] if rest.strip() else []
    base, mods = op.split(".")[0], op.split(".")[1:]
    wide = "WIDE" in mods or "64" in mods
    ins = Inst(addr, op, stall=(hi >> STALL_SHIFT) & 15, guarded=bool(guard),
               scoreboard=((hi >> WRITE_BARRIER_SHIFT) & 7) != NO_SCOREBOARD)
    n_dest = 0
    if base not in NO_DEST:
        if base.endswith("SETP") or base == "PLOP3":
            while n_dest < len(ops) and _PRED.match(ops[n_dest]):
                n_dest += 1
        else:  # predicates, one register, then predicates (carries, a shuffle's in-range flag)
            seen_reg = False
            while n_dest < len(ops):
                if _PRED.match(ops[n_dest]):
                    n_dest += 1
                elif not seen_reg and re.match(r"U?R(\d+|Z)$", ops[n_dest]):
                    seen_reg, n_dest = True, n_dest + 1
                else:
                    break
    for k, o in enumerate(ops):
        if k < n_dest:
            ins.writes += _regs(o, wide and o.startswith(("R", "UR")))
        else:
            # a wide multiply-add's addend and a 64-bit operation's operands are pairs
            pair = (base == "IMAD" and "WIDE" in mods and k == n_dest + 2) or (
                "64" in mods and not base.startswith("LD") and "[" not in o)
            ins.reads += _regs(o, pair)
    if guard:
        ins.reads += _regs(guard.group(1), False)
    if base == "BRA":
        m = re.search(r"\(?(\.L_x_\d+)\)?|\b0x([0-9a-f]+)\b", rest)
        ins.target = (m.group(1) or int(m.group(2), 16)) if m else None
    return ins


def functions(sass: str) -> dict:
    """{mangled name: ([Inst], {indices of instructions a label names})} of
    `cuobjdump -sass` output, branch targets resolved to addresses."""
    out = {}
    for part in re.split(r"\n\s*Function : ", "\n" + sass)[1:]:
        lines = part.splitlines()
        insts, labels, names = [], set(), {}
        for i, line in enumerate(lines):
            m = re.match(r"\s*(\.L_x_\d+):", line)
            if m:
                labels.add(len(insts))
                names[m.group(1)] = len(insts)
                continue
            m = _INST.match(line)
            hi = _CTRL.match(lines[i + 1]) if m and i + 1 < len(lines) else None
            if m and hi:
                insts.append(parse(m.group(2), int(hi.group(1), 16), int(m.group(1), 16)))
        addrs = {ins.addr: k for k, ins in enumerate(insts)}
        for ins in insts:
            if isinstance(ins.target, str):
                k = names.get(ins.target)
                ins.target = insts[k].addr if k is not None and k < len(insts) else None
            if ins.target in addrs:
                labels.add(addrs[ins.target])
        out[lines[0].strip()] = (insts, labels)
    return out


def latencies(insts: list, labels: set) -> dict:
    """{opcode: cycles}: for each fixed-latency opcode, the fewest cycles the
    schedule puts between it and the first reader of a result, inside a
    basic block."""
    lat = {}
    for i, a in enumerate(insts):
        if a.scoreboard or not a.writes:
            continue
        for d in a.writes:
            t = 0
            for j in range(i + 1, len(insts)):
                t += insts[j - 1].stall
                b = insts[j]
                if j in labels:
                    break
                if d in b.reads:
                    lat[a.op] = min(lat.get(a.op, t), t)
                    break
                if d in b.writes or b.op.split(".")[0] in ENDS_BLOCK:
                    break
    return lat


def _conditional(ins: Inst) -> bool:
    return ins.guarded or bool(ins.reads)  # a guard, or a predicate operand (BRA.U !UP0, ...)


def loops(insts: list, labels: set) -> list:
    """Each loop's body in the order a pass runs it: for each backward
    branch (latch to header), the blocks that reach the latch without
    passing the header, in reverse postorder from the header (a loop need
    not lie between its header and its latch as written). Blocks only a
    BRA.DIV reaches (the shuffles' code for a diverged warp) are left out."""
    addr_ix = {ins.addr: i for i, ins in enumerate(insts)}
    leaders = sorted({0} | set(labels) | {i + 1 for i, ins in enumerate(insts)
                                          if ins.op.split(".")[0] in ENDS_BLOCK} & set(range(len(insts))))
    starts = {s: k for k, s in enumerate(leaders)}
    spans = [(s, e) for s, e in zip(leaders, leaders[1:] + [len(insts)])]
    succ = []
    for k, (s, e) in enumerate(spans):
        last = insts[e - 1]
        base, out = last.op.split(".")[0], []
        # a BRA.DIV's target is the shuffles' fallback for a diverged warp, off every pass
        if base == "BRA" and "DIV" not in last.op.split(".") and last.target in addr_ix and \
                addr_ix[last.target] in starts:
            out.append(starts[addr_ix[last.target]])
        ends = base in ("BRX", "JMX") or base in ("BRA", "EXIT", "RET", "JMP") and not _conditional(last)
        if not ends and k + 1 < len(spans):
            out.append(k + 1)
        succ.append(out)
    # a BRX (a jump table, its targets not in the text) may reach every block
    # that nothing else reaches but a BRA.DIV's target
    div = {starts[addr_ix[ins.target]] for ins in insts if ins.op.startswith("BRA.DIV") and ins.target in addr_ix
           and addr_ix[ins.target] in starts}
    entered = {j for out in succ for j in out} | div | {0}
    for k, (s, e) in enumerate(spans):
        if insts[e - 1].op.split(".")[0] == "BRX":
            succ[k] = [j for j in range(len(spans)) if j not in entered]
    reached, work = {0}, [0]  # the blocks a pass can run, from the entry
    while work:
        for j in succ[work.pop()]:
            if j not in reached:
                reached.add(j)
                work.append(j)
    pred = [[] for _ in spans]
    for k, out in enumerate(succ):
        for j in out:
            pred[j].append(k)
    bodies = []
    for latch, out in enumerate(succ):
        for head in out:
            if head > latch or latch not in reached:
                continue
            members, work = {head, latch}, [latch]
            while work:
                for p in pred[work.pop()]:
                    if p not in members:
                        members.add(p)
                        work.append(p)
            order, seen = [], set()

            def visit(k):
                seen.add(k)
                for j in succ[k]:
                    if j in members and j not in seen and j != head:
                        visit(j)
                order.append(k)

            visit(head)
            bodies.append([insts[i] for k in reversed(order) for i in range(*spans[k])])
    return bodies


def ops(body: list) -> dict:
    """{opcode: count} of a body."""
    out = {}
    for ins in body:
        out[ins.op] = out.get(ins.op, 0) + 1
    return out


def dump(cuobjdump: str, lib: str, fragment: str = None, timeout: int = 120) -> str:
    """`cuobjdump -sass` of library `lib`: with `fragment`, of its one
    function whose mangled name holds it, found by name in `cuobjdump
    -symbols` ("" where the tool fails or finds none); else of the whole
    library (a small one: a variant built for one order)."""
    run = lambda *args: subprocess.run([cuobjdump, *args, lib], capture_output=True, text=True, timeout=timeout,
                                       check=True).stdout
    try:
        if not fragment:
            return run("-sass")
        for name in dict.fromkeys(re.findall(rf"[\w$]*{fragment}[\w$]*", run("-symbols"))):
            out = run("-sass", "-fun", name)
            if "Function :" in out:
                return out
    except (OSError, subprocess.SubprocessError):
        pass
    return ""


def chain(body: list, lat: dict) -> dict:
    """The body's chain a pass (cycles, instructions on it, variable-latency
    ones among them) and its issue stall cycles and instructions a pass."""
    default = min(lat.values(), default=1)
    ready = {}  # register -> (cycle ready, instructions on its chain, variable-latency ones)
    ends = []
    for _ in range(PASSES):
        end = (0, 0, 0)
        for ins in body:
            t, n, v = max((ready.get(r, (0, 0, 0)) for r in ins.reads), default=(0, 0, 0))
            cyc = ins.stall if ins.scoreboard else lat.get(ins.op, default)
            done = (t + cyc, n + 1, v + ins.scoreboard)
            for r in ins.writes:
                ready[r] = max(ready.get(r, (0, 0, 0)), done) if ins.guarded else done
            end = max(end, done)
        ends.append(end)
    half = PASSES // 2
    grow = [(a - b) / (PASSES - half) for a, b in zip(ends[-1], ends[half - 1])]
    return {"chain_cycles": grow[0], "chain_instructions": grow[1], "chain_variable": grow[2],
            "issue_cycles": sum(i.stall for i in body), "instructions": len(body)}


B1_STEPS_A_PASS = 32  # steps a pass of B1's loops: a warp's block, a tile (the parent's ring of 32)
# which of a B1 kernel's loops walks a row in each arithmetic, by its opcodes
B1_FORMS = {
    "64bit": lambda o: o.get("IMAD.WIDE.U32", 0) >= 32,
    "widening": lambda o: o.get("IMAD.WIDE", 0) >= 32,
    "32bit": lambda o: o.get("IMAD.WIDE.U32", 0) < 32 and o.get("IMAD.WIDE", 0) < 32 and o.get("IMAD", 0) >= 32,
}


def b1_chain(text: str, fragment: str, form: str):
    """B1's step by count in the SASS `text`: of the function whose name
    holds `fragment`, its largest loop in the arithmetic `form`, counted by
    chain() and divided by its steps (chain_cycles, chain_instructions,
    chain_variable, issue_cycles, instructions, each a step); None where
    the function or the loop is not found."""
    for name, (insts, labels) in functions(text).items():
        if fragment in name:
            bodies = [b for b in loops(insts, labels) if B1_FORMS[form](ops(b))]
            if not bodies:
                return None
            return {k: v / B1_STEPS_A_PASS for k, v in chain(max(bodies, key=len), latencies(insts, labels)).items()}
    return None
