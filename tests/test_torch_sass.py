"""The readers of nvcc's reports (``anemoi_tpu_torch/sass.py``) on listings
written in the tools' formats: ptxas -v's lines, cuobjdump -sass's and a
PTX file's functions, opcode counts.  Nothing here needs nvcc."""

import pytest

from anemoi_tpu_torch import sass

PTXAS = """\
ptxas info    : Compiling entry function '_Z13sponge_kernelILi4EEvPKiPixi12AnemoiConstsILi12EE' for 'sm_90a'
ptxas info    : Function properties for _Z13sponge_kernelILi4EEvPKiPixi12AnemoiConstsILi12EE
0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 72 registers, used 0 barriers
ptxas info    : Compiling entry function '_Z11jive_kernelILi4ELi2EEvPKiPix12AnemoiConstsILi12EE' for 'sm_90a'
ptxas info    : Function properties for _Z11jive_kernelILi4ELi2EEvPKiPix12AnemoiConstsILi12EE
0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 254 registers, used 0 barriers
"""

SASS = """\
\tcode for sm_90a
\t\tFunction : _Z13sponge_kernelILi2EEvPKiPixi12AnemoiConstsILi8EE
\t.headerflags\t@"EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                   /* 0x00000a00ff017b82 */
                                                                            /* 0x000fe20000000800 */
        /*fff0*/                   SHFL.IDX PT, R22, R29, RZ, 0x1c1f ;      /* 0x00001c1f1d167589 */
        /*10000*/              @!P3 IMAD.WIDE.U32 R8, R29, R22, RZ ;        /* 0x000000161d087225 */
        /*10010*/                  VOTE.ANY R9, PT, !P3 ;                   /* 0x0000000000097806 */
        /*10020*/             @UP0 STL [R1], R2 ;                           /* 0x0000000201007387 */
        /*10030*/                  NOP ;                                    /* 0x0000000000007918 */
\t\tFunction : _Z14permute_kernelILi4EEvPKiPix12AnemoiConstsILi8EE
        /*0000*/                   IMAD R35, R8, UR15, RZ ;                 /* 0x0000000f08237c24 */
"""


@pytest.mark.parametrize("mangled,name", [
    ("_Z13sponge_kernelILi4EEvPKiPixi12AnemoiConstsILi8EE", "sponge_kernel<4>"),
    ("_Z11jive_kernelILi4ELi2EEvPKiPix12AnemoiConstsILi12EE", "jive_kernel<4,2>"),
    ("_Z15mad_loop_kernelPii", "_Z15mad_loop_kernelPii"),
])
def test_kernel_name(mangled, name):
    assert sass.kernel_name(mangled) == name


def test_ptxas_table():
    assert sass.ptxas_table(PTXAS.splitlines()) == {"sponge_kernel<4>": (72, 8, 8), "jive_kernel<4,2>": (254, 0, 0)}


def test_sass_functions_and_counts():
    """Offsets of four and of five hex digits, predicates on the opcode,
    NOPs left out of the count."""
    funcs = sass.functions(SASS)
    assert list(funcs) == ["_Z13sponge_kernelILi2EEvPKiPixi12AnemoiConstsILi8EE",
                           "_Z14permute_kernelILi4EEvPKiPix12AnemoiConstsILi8EE"]
    first, second = funcs.values()
    assert len(first) == 6 and len(second) == 1
    assert sass.opcode_counts(first) == {"instructions": 5, "LDL": 0, "STL": 1, "SHFL": 1, "VOTE": 1, "IMAD": 1}
    assert sass.opcode_counts(second)["IMAD"] == 1


def test_ptx_functions():
    """A function ends at its closing brace at the start of a line (an inner
    block's is indented): what comes between it and the next (the next
    kernel's shared array) belongs to neither."""
    ptx = ("//\n.visible .entry _Z14permute_kernelILi2EEvPKiPix12AnemoiConstsILi8EE(\n\t.param .u64 a\n)\n{\n"
           "\t{\n\t}\n\tret;\n}\n.shared .align 4 .b8 tab[32768];\n"
           ".visible .entry _Z14permute_kernelILi4EEvPKiPix12AnemoiConstsILi8EE(\n{\n}\n")
    assert [len(v) for v in sass.functions(ptx, ".entry", r"\S").values()] == [8, 2]
    assert [len(v) for v in sass.functions(ptx, ".entry", r"\S", "}").values()] == [7, 2]


def test_innermost_loop():
    """The shortest span from a backward branch back to its target."""
    lines = ["/*0000*/ MOV R1, R2 ;", "/*0010*/ IMAD R3, R1, R1, RZ ;", "/*0020*/ SHFL.IDX PT, R4, R3, RZ, 0x1c1f ;",
             "/*0030*/ @P0 BRA 0x10 ;", "/*0040*/ BRA 0x0 ;", "/*0050*/ BRA 0x60 ;", "/*0060*/ EXIT ;"]
    assert sass.innermost_loop(lines) == lines[1:4]
    assert sass.opcode_counts(sass.innermost_loop(lines)) == {"instructions": 3, "LDL": 0, "STL": 0, "SHFL": 1,
                                                             "VOTE": 0, "IMAD": 1}
    assert sass.innermost_loop(lines[:1]) == []


def test_compare():
    """A kernel's instructions alike in two builds but for their encodings,
    and its PTX but for the numbers of its basic-block labels, is "same";
    an operand that differs is "changed"; a kernel the other build lacks is
    "new"."""
    funcs = sass.functions(SASS)
    name = "_Z13sponge_kernelILi2EEvPKiPixi12AnemoiConstsILi8EE"
    ptx = {name: ["ret;"]}
    reencoded = {name: [line.replace("0x00000a00ff017b82", "0x00000a00ff017b83") for line in funcs[name]]}
    verdict = sass.compare(name, (funcs, ptx), (reencoded, ptx))
    assert verdict.startswith("sponge_kernel<2>: same; PTX the same") and "encodings differ" in verdict
    other = {name: [line.replace("R29, R22", "R29, R23") for line in funcs[name]]}
    assert sass.compare(name, (funcs, ptx), (other, ptx)).startswith("sponge_kernel<2>: changed")
    assert "2 lines differ" in sass.compare(name, (funcs, ptx), (other, ptx))
    assert sass.compare(name, (funcs, ptx), ({}, {})) == "sponge_kernel<2>: new (6 SASS instructions)"
    relabelled = {name: ["@%p1 bra $L__BB4_2;", "$L__BB4_2:"]}
    assert "same; PTX the same" in sass.compare(name, (funcs, {name: ["@%p1 bra $L__BB2_2;", "$L__BB2_2:"]}),
                                                (funcs, relabelled))
    assert "PTX differs" in sass.compare(name, (funcs, {name: ["@%p1 bra $L__BB2_3;", "$L__BB2_2:"]}),
                                         (funcs, relabelled))


def test_ptx_diff():
    """The difference of one kernel's PTX in two builds, labels and virtual
    registers numbered alike, cut at `limit` lines; nothing where only
    those numbers differ."""
    name = "_Z13sponge_kernelILi2EEvPKiPixi12AnemoiConstsILi8EE"
    this = ({}, {name: ["$L__BB2_2:", "add.s32 %r1, %r2, 1;", "ret;"]})
    other = ({}, {name: ["$L__BB4_2:", "sub.s32 %r1, %r2, 1;", "ret;"]})
    assert sass.ptx_diff(name, this, other, 20) == ["--- ", "+++ ", "@@ -1,3 +1,3 @@", " $L__BB_2:",
                                                    "-sub.s32 %r_0, %r_1, 1;", "+add.s32 %r_0, %r_1, 1;", " ret;"]
    assert len(sass.ptx_diff(name, this, other, 4)) == 4
    assert sass.ptx_diff(name, this, ({}, {name: ["$L__BB7_2:", "add.s32 %r5, %r9, 1;", "ret;"]}), 20) == []


def test_ptx_labelled_renames_registers():
    """Virtual registers of each class are renamed in the order they first
    appear, their declared counts dropped; special registers, and a
    register used where its twin used another, are kept apart."""
    lines = [".reg .b32 %r<12251>;", ".reg .b64 %rd<7>;", "mov.u32 %r12105, %tid.x;",
             "add.s64 %rd3, %rd3, 4;", "setp.eq.s32 %p2, %r12105, 0;", "add.s32 %r581, %r12105, 1;"]
    assert sass.ptx_labelled(lines) == [".reg .b32 %r<>;", ".reg .b64 %rd<>;", "mov.u32 %r_0, %tid.x;",
                                        "add.s64 %rd_0, %rd_0, 4;", "setp.eq.s32 %p_0, %r_0, 0;",
                                        "add.s32 %r_1, %r_0, 1;"]
    twin = [line.replace("%r12105", "%r12107").replace("<12251>", "<12253>") for line in lines]
    assert sass.ptx_labelled(twin) == sass.ptx_labelled(lines)
    swapped = lines[:5] + ["add.s32 %r581, %r581, 1;"]
    assert sass.ptx_labelled(swapped) != sass.ptx_labelled(lines)


@pytest.mark.parametrize("source", ["jive.cu", "sponge.cu"])
def test_bounds_sweep_sets_the_sources_constants(source):
    """Every constant the sweep sets by -D is one the source lets a -D
    override, and every kernel it times is bounded by one of them."""
    from anemoi_tpu_torch import _build, bounds_sweep

    text = (_build.CSRC / source).read_text()
    for macro in bounds_sweep.MACROS[source]:
        assert f"#ifndef {macro}\n#define {macro} " in text
        assert macro in text[text.index("__launch_bounds__(BLOCK, "):]
    assert bounds_sweep.defines(source, 3) == tuple(f"-D{m}=3" for m in bounds_sweep.MACROS[source])
    timed = [k for k in bounds_sweep.KERNELS if k[0] == source]
    assert timed and all(k[2] in bounds_sweep.MACROS[source] and k[1].split("<")[0] in text for k in timed)


@pytest.mark.parametrize("source", ["jive_mma.cu", "sponge_mma.cu"])
def test_bounds_sweep_sets_the_mma_sources_constants(source):
    """As for the integer sources: every constant the sweep sets by -D in a
    tensor-core source is one that a -D overrides and that bounds a kernel
    the sweep times, and so is each block shape it builds."""
    from anemoi_tpu_torch import _build, bounds_sweep

    text = (_build.CSRC / source).read_text()
    bounds = text[text.index("__launch_bounds__(MMA_BLOCK, "):]
    for macro in bounds_sweep.MACROS[source]:
        assert f"#ifndef {macro}\n#define {macro} " in text and macro in bounds
    for macro, _ in bounds_sweep.SHAPES.get(source, ()):
        assert f"#ifndef {macro}\n#define {macro} " in text
    timed = [k for k in bounds_sweep.KERNELS if k[0] == source]
    assert timed and all(k[2] in bounds_sweep.MACROS[source] and k[1].split("<")[0] in text for k in timed)
    assert set(sass.MMA_KERNELS[source]) == {k[1].split("<")[0] for k in timed}


def test_innermost_loop_holding_and_product_mix():
    """With `holding`, the shortest loop that holds that opcode (the ladder's
    trip, not a copy loop); product_mix counts its instructions by kind,
    over the products a trip runs."""
    lines = ["/*0000*/ LDG.E R1, [R2.64] ;", "/*0010*/ STS [R3], R1 ;", "/*0020*/ @P0 BRA 0x0 ;",
             "/*0030*/ IMMA.16832.U8.U8 R4, R6.ROW, R8.COL, R4 ;", "/*0040*/ IMAD.WIDE.U32 R10, R1, R2, RZ ;",
             "/*0050*/ SHFL.IDX PT, R4, R3, RZ, 0x1c1f ;", "/*0060*/ LOP3.LUT R5, R4, 0xff, RZ, 0xc0, !PT ;",
             "/*0070*/ IADD3 R6, R5, R4, RZ ;", "/*0080*/ @P1 BRA 0x30 ;", "/*0090*/ EXIT ;"]
    assert sass.innermost_loop(lines) == lines[:3]
    assert sass.innermost_loop(lines, "IMMA") == lines[3:9]
    assert sass.product_mix(sass.innermost_loop(lines, "IMMA"), products=2) == {
        "IMMA": 0.5, "IMAD": 0.5, "SHFL": 0.5, "VOTE": 0.0, "ALU": 1.0, "instructions": 3.0}


def test_product_loop_window_and_ladder():
    """The loop counted is the window's trip, not the table's trip nor the
    round loop around both: one state a thread, twice the IMMAs of the
    table's trip (a squaring and a product); in the quad form, the shortest
    IMMA loop that stores nothing to shared memory (a squaring and a product
    share its code), over the width's columns."""
    lines = ["/*0000*/ MOV R1, R2 ;",
             "/*0010*/ IMMA.16832.U8.U8 R4, R6.ROW, R8.COL, R4 ;", "/*0020*/ STS [R3], R4 ;",
             "/*0030*/ @P0 BRA 0x10 ;",  # the table: one product and its store
             "/*0040*/ IMMA.16832.U8.U8 R4, R6.ROW, R8.COL, R4 ;", "/*0050*/ IMAD R5, R4, R4, RZ ;",
             "/*0060*/ @P1 BRA 0x40 ;",  # the squaring's way back
             "/*0070*/ IMMA.16832.U8.U8 R4, R6.ROW, R10.COL, R4 ;", "/*0080*/ LDS R6, [R3] ;",
             "/*0090*/ BRA 0x40 ;",  # the product's way back: the window's trip
             "/*00a0*/ @P2 BRA 0x0 ;", "/*00b0*/ EXIT ;"]  # the round loop
    body, products = sass.product_loop("jive_mma_kernel<2,2>", lines)
    assert (body, products) == (lines[4:10], 2)
    assert sass.product_mix(body, products)["IMMA"] == 1.0
    body, products = sass.product_loop("permute_mma_kernel<4>", lines)
    assert (body, products) == (lines[4:7], 2)
    assert sass.innermost_loop(lines, "IMMA") == lines[1:4]
