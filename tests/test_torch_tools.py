"""racon_tpu_torch's outer tools against racon_tpu's, on the CPU: the
sampler (split, subsample), the paired-end preprocess and the wrapper.

The sampler and preprocess give the JAX modules' files and output on the
same generated inputs. The wrapper, run in-process with --split, gives
the JAX wrapper's bytes: with ``--device cpu`` (the kernels' plain
versions) those of the JAX wrapper with ``--tpu`` (its Hirschberg
aligner), with ``--host`` (and with ``--subsample`` too) those of the JAX
wrapper without it; ``--resume`` reuses its checkpoints. One test
starts processes: ``--jobs 2`` (two CLI workers) gives the sequential
run's bytes.
"""

import gzip
import io
import os
import random
import subprocess
import sys

import pytest
import torch

from racon_tpu.tools import preprocess as jpreprocess
from racon_tpu.tools import sampler as jsampler
from racon_tpu.tools import wrapper as jwrapper

from racon_tpu_torch.tools import preprocess, sampler, simulate, wrapper

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ["-w", "100", "-m", "5", "-x", "-4", "-g", "-8"]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def three(tmp_path_factory):
    """A three-contig set with short reads (PAF)."""
    d = simulate.generate(str(tmp_path_factory.mktemp("tools")), mbp=0.0024,
                          coverage=8, mean_read=500, seed=7, contigs=3)
    return d["reads"], d["overlaps"], d["draft"]


def _reads(path, n=40, fastq=True, seed=3):
    rng = random.Random(seed)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wt") as f:
        for i in range(n):
            s = "".join(rng.choice("ACGT")
                        for _ in range(rng.randint(20, 300)))
            if fastq:
                f.write(f"@r{i} extra\n{s}\n+\n{'I' * len(s)}\n")
            else:
                f.write(f">r{i}\n{s[:len(s) // 2]}\n{s[len(s) // 2:]}\n")
    return path


def _files(paths):
    out = {}
    for p in paths:
        with open(p) as f:
            out[os.path.basename(p)] = f.read()
    return out


@pytest.mark.parametrize("name", ["r.fastq", "r.fasta", "r.fq.gz",
                                  "r.fa.gz"])
def test_sampler_split_and_subsample_match_jax(tmp_path, name):
    src = _reads(str(tmp_path / name), fastq="q" in name)
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir()
    b.mkdir()
    for size in (1, 700, 10 ** 6):
        assert _files(sampler.split(src, size, str(a))) == \
            _files(jsampler.split(src, size, str(b)))
    for cov in (1, 3, 1000):
        got = sampler.subsample(src, 1000, cov, str(a))
        want = jsampler.subsample(src, 1000, cov, str(b))
        assert os.path.basename(got) == os.path.basename(want)
        assert _files([got]) == _files([want])
        assert sampler.subsample_path(src, cov, str(a)) == got


def test_sampler_cli_matches_jax(tmp_path):
    src = _reads(str(tmp_path / "r.fastq"))
    for args in (["split", src, "500"], ["subsample", src, "1000", "2"]):
        assert sampler.main(["-o", str(tmp_path / "a"), *args]) == 0
        assert jsampler.main(["-o", str(tmp_path / "b"), *args]) == 0
    a = sorted(os.listdir(tmp_path / "a"))
    assert a == sorted(os.listdir(tmp_path / "b")) and len(a) > 2
    assert _files([str(tmp_path / "a" / n) for n in a]) == \
        _files([str(tmp_path / "b" / n) for n in a])
    with pytest.raises(SystemExit):
        sampler.split(str(tmp_path / "r.txt"), 10, str(tmp_path))


@pytest.mark.parametrize("gz", [False, True])
def test_preprocess_matches_jax(tmp_path, gz):
    ext = ".fastq.gz" if gz else ".fastq"
    first = _reads(str(tmp_path / f"a{ext}"), seed=1)
    second = _reads(str(tmp_path / f"b{ext}"), seed=2)
    got, want = io.StringIO(), io.StringIO()
    seen, jseen = set(), set()
    for path in (first, second):
        preprocess.parse_file(path, seen, got)
        jpreprocess.parse_file(path, jseen, want)
    assert got.getvalue() == want.getvalue()
    assert "r0 extra" not in got.getvalue() and "@r01\n" in got.getvalue()
    assert "@r02\n" in got.getvalue()


def test_preprocess_refuses_what_is_not_fastq(tmp_path):
    bad = tmp_path / "bad.fastq"
    bad.write_text("@r1\nACGT\n+\nIIIII\n")
    with pytest.raises(SystemExit):
        preprocess.parse_file(str(bad), set(), io.StringIO())


def _wrap(main, argv, capsys, monkeypatch, cwd):
    monkeypatch.chdir(cwd)
    assert main(argv) == 0
    out = capsys.readouterr().out
    assert not [n for n in os.listdir(cwd) if "work_directory" in n]
    return out


def test_wrapper_on_the_cpu_equals_the_jax_wrappers(three, tmp_path,
                                                    capsys, monkeypatch):
    argv = ["--split", "700", *FLAGS, *three]
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    got = _wrap(wrapper.main, ["--device", "cpu", *argv], capsys,
                monkeypatch, tmp_path / "a")
    monkeypatch.setenv("RACON_TPU_DEVICE_ALIGNER", "hirschberg")
    want = _wrap(jwrapper.main, ["--tpu", *argv], capsys, monkeypatch,
                 tmp_path / "b")
    assert got == want and got.count(">") == 3
    host = _wrap(wrapper.main, ["--host", *argv], capsys, monkeypatch,
                 tmp_path / "a")
    jhost = _wrap(jwrapper.main, argv, capsys, monkeypatch, tmp_path / "b")
    assert host == jhost and host.count(">") == 3
    sub = ["--subsample", "2400", "4", *argv]
    host = _wrap(wrapper.main, ["--host", *sub], capsys, monkeypatch,
                 tmp_path / "a")
    jhost = _wrap(jwrapper.main, sub, capsys, monkeypatch, tmp_path / "b")
    assert host == jhost and host.count(">") > 0


def test_wrapper_resume_reuses_its_checkpoints(three, tmp_path, capsys,
                                               monkeypatch):
    work = tmp_path / "work"
    argv = ["--host", "--split", "700", "--resume", str(work), *FLAGS,
            *three]
    first = _wrap(wrapper.main, argv, capsys, monkeypatch, tmp_path)
    done = sorted(n for n in os.listdir(work) if n.startswith("polished_"))
    assert len(done) == 3
    os.remove(work / done[1])
    monkeypatch.chdir(tmp_path)
    assert wrapper.main(argv) == 0
    captured = capsys.readouterr()
    assert captured.out == first
    assert captured.err.count("reusing checkpointed result") == 2
    with pytest.raises(SystemExit):
        wrapper.main(["--host", "--split", "900", "--resume", str(work),
                      *FLAGS, *three])


def test_wrapper_runs_on_the_card_by_default(three, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        wrapper.main(["--split", "700", *FLAGS, *three])
    cmd = wrapper._worker_cmd(wrapper.build_arg_parser().parse_args(
        ["-u", *FLAGS, *three]), "s.fq", "part.fa")
    assert cmd[1:3] == ["-m", "racon_tpu_torch.cli"]
    assert cmd[-3:] == ["s.fq", os.path.abspath(three[1]), "part.fa"]
    assert "--device" in cmd and cmd[cmd.index("--device") + 1] == "cuda"
    assert "-u" in cmd and cmd[-1] == "part.fa"


def test_wrapper_jobs_equal_sequential(three, tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    outs = []
    for extra in ([], ["--jobs", "2"]):
        r = subprocess.run(
            [sys.executable, "-m", "racon_tpu_torch.tools.wrapper",
             "--device", "cpu", "--split", "700", *extra, *FLAGS, *three],
            cwd=str(tmp_path), env=env, capture_output=True, text=True,
            timeout=600)
        assert r.returncode == 0, r.stderr[-2000:]
        outs.append(r.stdout)
    assert outs[0] == outs[1] and outs[0].count(">") == 3
    assert not [n for n in os.listdir(tmp_path) if "work_directory" in n]
