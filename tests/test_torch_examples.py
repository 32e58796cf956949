"""The port's example programs and its unit-test CLI, run in-process
through `main(argv)` on the CPU at the sizes of tests/test_examples.py
(mirrors it and test_cli.py's unit_test case): each prints `Validation =
True` and exits 0.  The distributed ones run in a group of one, which
they make themselves."""

import pytest

from sblas_tpu_torch.cli import unit_test
from sblas_tpu_torch.examples import cg, pagerank, pagerank_dist


@pytest.mark.parametrize("main,argv,said", [
    (cg.main, ["--n", "3000", "--f64", "--tol", "1e-8"], "plan: DiaPlan"),
    (cg.main, ["--n", "3000", "--f64", "--dist", "4", "--tol", "1e-8"],
     "distributed over 1 device(s)"),
    (cg.main, ["--n", "3000", "--tol", "1e-6"], "CG:"),
    (pagerank.main, ["--n", "20000", "--tol", "1e-7"], "PageRank:"),
    (pagerank_dist.main, ["--n", "12000", "--tol", "1e-8"], "xfoot"),
    (unit_test.main, [], "spmvCsrTest: PASS"),
], ids=["cg", "cg_dist", "cg_f32", "pagerank", "pagerank_dist",
        "unit_test"])
def test_example_validates(capsys, main, argv, said):
    rc = main([*argv, "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "Validation = True" in out and said in out


def test_unit_test_cli_reads_a_given_matrix(tmp_path, capsys):
    from sblas_tpu_torch.io.generate import pattern_symmetric
    from sblas_tpu_torch.io.mmio import write_mtx
    A = pattern_symmetric(n=120, nnz_target=500, seed=3)
    coo = A.to_coo()
    path = str(tmp_path / "a.mtx")
    write_mtx(path, *A.shape, coo.row_idx, coo.col_idx, coo.values)
    assert unit_test.main([path, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "missing" not in out and "Validation = True" in out


def test_examples_refuse_cuda_without_a_card(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (cg.main, pagerank.main, pagerank_dist.main, unit_test.main):
        assert main(["--device", "cuda"]) == 2
