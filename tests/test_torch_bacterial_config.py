"""The benchmark's long-genome configuration (``bacterial-tuned``, LZ-ANI's
``--mal 20 --msl 11 --reg 80``) on the port's normal path, on the CPU
(the kernels' plain versions): a small species set of the cell's mix
(``species``, 2 relatives a species) goes through ``Matcher`` with the
``cuda`` backend, every row takes the long-genome path, and the TSV and
ids files equal the benchmark's plain reference (``benchmark/reference``)
for every pair, as the cell's check compares them."""
import os

import pytest

from benchmark import check, generate, harness
from benchmark.reference import tsv
from lzani_tpu_torch.matcher import Matcher


@pytest.fixture(scope="module")
def cell():
    return harness.load_cell(harness.ROOT, "bacterial-cuda")


def test_the_cell_is_the_long_genome_deployment(cell):
    config = cell["config"]
    assert config["params"] == {"mal": 20, "msl": 11, "mrd": 40, "mqd": 40,
                                "reg": 80, "aw": 15, "am": 7, "ar": 3}
    assert (config["backend"], config["threads"]) == ("cuda", 0)
    assert cell["traffic"]["generator"] == "bacterial"
    assert {m["name"] for m in cell["end_to_end"]} == {"pairs_per_s",
                                                       "setup_s"}
    assert {m["name"] for m in cell["per_layer"]} == {
        "big.kmers_device_s", "big.sort_device_s", "big.search_device_s",
        "big.next_hit_device_s", "replay.big_wall_s",
        "kernels.big_roofline", "ingest.mb_per_s"}


def test_every_pair_equals_the_plain_reference(cell, tmp_path):
    config = cell["config"]
    mix = dict(cell["traffic"], relatives=2)
    names, codes, fam = generate.collection(
        2, 0, {"species_lengths": [20_000, 40_000]}, mix)
    assert len(codes) == 6 and set(fam) == {0, 1}
    fasta, out = str(tmp_path / "in.fna"), str(tmp_path / "out.tsv")
    generate.write_fasta(fasta, names, codes)
    p = harness.make_params(config, fasta, out)
    p.no_threads = 2
    m = Matcher(p, device="cpu")
    assert m.run_all2all()
    st = m.engine_stats
    n = len(codes)
    assert st["big_rows"] == n and st["kernel_pairs"] == 0
    assert st["big_pairs"] == n * (n - 1) and st["big_cap_fallbacks"] == 0
    pairs = [(a, b) for a in range(n) for b in range(a + 1, n)]
    ref = check.Collection(names, codes, check.lz_cfg(config["params"]),
                           pairs, tsv.FORMATS[config["output"]["format"]])
    ref.compute()
    got = check.compare_job(ref, harness._read_lines(out), harness._read_lines(
        os.path.join(str(tmp_path), "out.ids.tsv")))
    assert got == {"ids_lines_differ": 0, "tsv_keys_differ": 0,
                   "sampled_lines_differ": 0}
    # the related pairs align: both their lines read an ani above 0.9
    lines = harness._read_lines(out)
    assert len(lines) == 1 + n * (n - 1)
    related = [key for (a, b), key in zip(pairs, ref.pairs_new())
               if fam[a] == fam[b]]
    assert len(related) == 6
    assert all(float(ln.split("\t")[6]) > 0.9
               for key in related for ln in ref.expected[key])
