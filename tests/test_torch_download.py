"""Offline tests of the port's RefSeq fetcher (``bonsai_tpu_torch/scripts/
download_genomes.py``): summary parsing, selection, URLs, the nameidmap
and the gzip check, as ``tests/test_download.py`` tests the JAX
package's, and each against the JAX package's on the same canned
summary; a clade already on disk is not fetched again.  Nothing here
touches the network: the resume test replaces the fetch with one that
fails the test."""

import gzip
import io

import pytest

from bonsai_tpu.scripts import download_genomes as jdg

from bonsai_tpu_torch.scripts import download_genomes as dg

SUMMARY = """#   See assembly summary file format
# assembly_accession\tbioproject\tbiosample\twgs_master\trefseq_category\ttaxid\tspecies_taxid\torganism_name\tinfraspecific_name\tisolate\tversion_status\tassembly_level\trelease_type\tgenome_rep\tseq_rel_date\tasm_name\tsubmitter\tgbrs_paired_asm\tpaired_asm_comp\tftp_path\texcluded_from_refseq\trelation_to_type_material
GCF_000005845.2\tPRJNA57779\tSAMN02604091\t\treference genome\t511145\t562\tEscherichia coli K-12\t\t\tlatest\tComplete Genome\tMajor\tFull\t2013/09/26\tASM584v2\tUniv\tGCA_000005845.2\tidentical\tftp://ftp.ncbi.nlm.nih.gov/genomes/all/GCF/000/005/845/GCF_000005845.2_ASM584v2\t\t
GCF_000008865.1\tPRJNA57781\tSAMN02604092\t\tna\t386585\t562\tEscherichia coli O157\t\t\tlatest\tScaffold\tMajor\tFull\t2013/09/26\tASM886v1\tUniv\tGCA_000008865.1\tidentical\tftp://ftp.ncbi.nlm.nih.gov/genomes/all/GCF/000/008/865/GCF_000008865.1_ASM886v1\t\t
GCF_000007445.1\tPRJNA57915\tSAMN02604093\t\trepresentative genome\t199310\t562\tEscherichia coli CFT073\t\t\tlatest\tComplete Genome\tMajor\tFull\t2013/09/26\tASM744v1\tUniv\tGCA_000007445.1\tidentical\tftp://ftp.ncbi.nlm.nih.gov/genomes/all/GCF/000/007/445/GCF_000007445.1_ASM744v1\t\t
GCF_BAD\tx\tx\t\tna\tnotanint\t1\tBroken\t\t\tlatest\tComplete Genome\tMajor\tFull\t2013\tX\tY\tZ\tidentical\tftp://example/x\t\t
GCF_NOFTP\tx\tx\t\tna\t5\t5\tNoFtp\t\t\tlatest\tComplete Genome\tMajor\tFull\t2013\tX\tY\tZ\tidentical\tna\t\t
GCF_SHORT\tx\tx
"""


def test_parse_and_select():
    asm = dg.parse_assembly_summary(io.StringIO(SUMMARY))
    assert len(asm) == 3  # bad taxid, missing ftp and short rows dropped
    a = asm[0]
    assert a.accession == "GCF_000005845.2"
    assert a.taxid == 511145 and a.species_taxid == 562
    assert a.ftp_path.startswith("https://")
    assert a.fna_url.endswith(
        "GCF_000005845.2_ASM584v2/GCF_000005845.2_ASM584v2_genomic.fna.gz")
    sel = dg.select_assemblies(asm)
    assert [x.accession for x in sel] == ["GCF_000005845.2",
                                          "GCF_000007445.1"]
    rep = dg.select_assemblies(asm, complete_only=False,
                               representative_only=True)
    assert [x.accession for x in rep] == ["GCF_000005845.2",
                                          "GCF_000007445.1"]
    assert dg.select_assemblies(asm, complete_only=False) == asm


@pytest.mark.parametrize("complete_only", [True, False])
@pytest.mark.parametrize("representative_only", [True, False])
def test_parse_and_select_match_jax(complete_only, representative_only):
    got = dg.select_assemblies(dg.parse_assembly_summary(
        io.StringIO(SUMMARY)), complete_only, representative_only)
    want = jdg.select_assemblies(jdg.parse_assembly_summary(
        io.StringIO(SUMMARY)), complete_only, representative_only)
    assert [tuple(a) for a in got] == [tuple(a) for a in want]
    assert [a.fna_url for a in got] == [a.fna_url for a in want]


def test_nameidmap_and_gzip_check(tmp_path):
    asm = dg.select_assemblies(dg.parse_assembly_summary(io.StringIO(SUMMARY)))
    nm, jnm = tmp_path / "nameidmap.txt", tmp_path / "jax_nameidmap.txt"
    dg.write_nameidmap(asm, str(nm))
    jdg.write_nameidmap(jdg.select_assemblies(jdg.parse_assembly_summary(
        io.StringIO(SUMMARY))), str(jnm))
    assert nm.read_text() == ("GCF_000005845.2\t511145\n"
                              "GCF_000007445.1\t199310\n")
    assert nm.read_bytes() == jnm.read_bytes()
    good = tmp_path / "ok.gz"
    with gzip.open(good, "wb") as fh:
        fh.write(b"ACGT" * 1000)
    assert dg.is_valid_gzip(str(good))
    bad = tmp_path / "bad.gz"
    bad.write_bytes(b"\x1f\x8b" + b"garbage")
    assert not dg.is_valid_gzip(str(bad))
    cut = tmp_path / "cut.gz"
    cut.write_bytes(good.read_bytes()[:-9])  # a stream cut short
    assert not dg.is_valid_gzip(str(cut))
    for p in (good, bad, cut):
        assert dg.is_valid_gzip(str(p)) == jdg.is_valid_gzip(str(p))


def test_summary_url():
    assert dg.summary_url("bacteria").endswith(
        "refseq/bacteria/assembly_summary.txt")
    for clade in dg.DEFAULT_CLADES:
        assert dg.summary_url(clade) == jdg.summary_url(clade)
    assert dg.DEFAULT_CLADES == jdg.DEFAULT_CLADES
    assert dg.TAXDUMP_URL == jdg.TAXDUMP_URL


def test_a_clade_on_disk_is_not_fetched_again(tmp_path, monkeypatch):
    """The summary and every selected genome already there and whole:
    ``download_clade`` writes the nameidmap and returns the local paths,
    fetching nothing."""
    def no_fetch(url, dest, retries=3):
        raise AssertionError(f"fetched {url}")

    monkeypatch.setattr(dg, "_fetch", no_fetch)
    clade = tmp_path / "ref" / "bacteria"
    clade.mkdir(parents=True)
    (clade / "assembly_summary.txt").write_text(SUMMARY)
    want = []
    for a in dg.select_assemblies(dg.parse_assembly_summary(
            io.StringIO(SUMMARY))):
        p = clade / a.fna_url.rsplit("/", 1)[-1]
        with gzip.open(p, "wb") as fh:
            fh.write(b">x\nACGT\n")
        want.append(str(p))
    got = dg.download_clade("bacteria", str(tmp_path / "ref"), threads=2)
    assert got == want
    assert (clade / "nameidmap.txt").read_text() == (
        "GCF_000005845.2\t511145\nGCF_000007445.1\t199310\n")
