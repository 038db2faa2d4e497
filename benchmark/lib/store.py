"""Set-up shared by the cells over one sequencing deployment: the inputs
from the seed, and the port's read store built from them as ``create
--paired`` builds it (error-free reads stand for reads after correction)."""

from __future__ import annotations

import numpy as np

from benchmark.lib import generator


def library(config: dict, seed: int):
    """(genome, codes, lengths, mate_of, truth) of a configuration's sample
    (one for every seed) and a sequencing run of it (the seed's reads);
    every count comes from the configuration."""
    g = generator.genome(config["genome_length"])
    lib = config["library"]
    n_pairs = round(config["genome_length"] * lib["depth"] / (2 * lib["read_len"]))
    v = config["variants"]
    codes, lengths, truth = generator.paired_library(
        g, seed, n_pairs,
        n_het=v["het_snvs"], n_hom=v["hom_snvs"], n_indel=v["indels"],
        hom_dels=v["hom_dels"], het_dels=v["het_dels"], big_del=v["big_del"],
        ins=v["insertions"], long_ins=v["long_insertions"],
        read_len=lib["read_len"], error_rate=lib["error_rate"], gap=v["sv_gap"],
        ploidy=config["ploidy"], trimmed_share=lib["trimmed_share"],
        frag_mean=lib["fragment_mean"], frag_sd=lib["fragment_sd"],
    )
    return g, codes, lengths, generator.mates(len(lengths)), truth


def reference(genome: np.ndarray, name: str):
    """The port's Reference of one contig."""
    from biograph_tpu_torch.index.reference import Contig, Reference

    return Reference(flat=genome, is_n=np.zeros(len(genome), bool), contigs=[Contig(name=name, start=0, length=len(genome))])


def build(codes, lengths, mate_of, device):
    """(seqset, readmap) on ``device``, as ``create`` builds them: the
    seqset under the device's detected memory budget, then the readmap
    with the mates."""
    import torch

    from biograph_tpu_torch.build.readmap_build import build_readmap
    from biograph_tpu_torch.build.seqset_build import build_seqset
    from biograph_tpu_torch.runtime.resources import MemoryBudget

    ss = build_seqset(codes, lengths, budget=MemoryBudget.detect(device), device=device)
    rm = build_readmap(ss, codes, lengths, mate_of, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return ss, rm
