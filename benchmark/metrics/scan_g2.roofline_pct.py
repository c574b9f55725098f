"""scan_g2.roofline_pct: k_scan_g2's share of its roofline in the
traced proofs (benchmark/scanroof.py)."""

from benchmark.scanroof import share


def read(run):
    return share(run, "g2")
