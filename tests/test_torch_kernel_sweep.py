"""tools/kernel_sweep.py's instruction counter on cuobjdump -sass listings
made up for the test (the card's listings are read on the card): innermost
loops found through both branch forms (a label, an address), instructions
per reciprocal, the main loop first and a loop with a square root (a
sphere test) last, loops without a reciprocal and outer loops left out."""

import torch

from bidirectional_pathtracing_tpu_torch.tools import kernel_sweep as ks

LISTING = """
\tcode for sm_90a
\t\tFunction : _Z4testPf
\t.headerflags\t@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/       LDC R1, c[0x0][0x28] ;   /* 0x00000a00ff017b82 */
                                                /* 0x000fe40000000800 */
.L_x_0:
        /*0010*/                   S2R R0, SR_TID.X ;
.L_x_1:
        /*0020*/                   LDS.128 R4, [R2] ;
        /*0030*/                   FADD R5, R4, -R6 ;
        /*0040*/                   FMUL R7, R5, R5 ;
        /*0050*/                   MUFU.RCP R8, R7 ;
        /*0060*/                   FSETP.GEU.AND P0, PT, R8, RZ, PT ;
        /*0070*/                   MUFU.RCP R9, R7 ;
        /*0080*/               @P0 BRA `(.L_x_1) ;
        /*0090*/                   FADD R5, R4, -R6 ;
        /*00a0*/                   MUFU.RCP R9, R7 ;
        /*00b0*/              @!P1 BRA 0x90 ;
        /*00c0*/                   IADD3 R3, R3, 0x1, RZ ;
        /*00d0*/              @!P2 BRA `(.L_x_0) ;
        /*00e0*/                   FADD R5, R4, -R6 ;
        /*00f0*/              @!P3 BRA 0xe0 ;
        /*0100*/                   MUFU.RSQ R8, R7 ;
        /*0110*/                   MUFU.RCP R9, R7 ;
        /*0120*/                   MUFU.RCP R9, R8 ;
        /*0130*/                   MUFU.RCP R9, R5 ;
        /*0140*/              @!P3 BRA 0x100 ;
        /*0150*/                   EXIT ;
\t\tFunction : _Z4idlePf
        /*0000*/                   MOV R1, R2 ;
        /*0010*/                   BRA 0x10 ;
"""


def test_count_tests_on_a_listing():
    got = ks.count_tests(LISTING)
    assert list(got) == ["_Z4testPf"]
    main, tail, sphere = got["_Z4testPf"]
    assert (main["from"], main["to"]) == (0x20, 0x80)
    assert (main["instructions"], main["rcp"], main["rsq"]) == (7, 2, 0)
    assert main["per_test"] == 3.5
    assert main["by_class"] == {"branch": 0.5, "compare_select": 0.5,
                                "fp32": 1.0, "rcp": 1.0, "shared_load": 0.5}
    assert (tail["from"], tail["to"], tail["per_test"]) == (0x90, 0xb0, 3.0)
    assert (sphere["from"], sphere["rcp"], sphere["rsq"]) == (0x100, 3, 1)


def test_sass_files_are_counted_without_a_card(tmp_path, capsys):
    path = tmp_path / "k.sass"
    path.write_text(LISTING)
    out = tmp_path / "out.json"
    assert ks.main(["--sass", str(path), "--out", str(out)]) == 0
    assert '"per_test": 3.5' in capsys.readouterr().out
    if not torch.cuda.is_available():
        assert ks.main(["--out", str(out)]) == 2
