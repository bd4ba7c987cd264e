"""Inner-alignment VCF emission and the final somatic merge.

Re-implements reference src/OutVCF.py (bed2vcf + header) and the merge in
src/SVscope.py:318-338: every RF-scored window becomes a VCF record with
REF=germline consensus / ALT=somatic consensus and
ConfidenceSV/DecisionSV INFO fields; the merged VCF keeps only
DecisionSV=True rows plus the InterALNSVs body, position-sorted.
"""
from __future__ import annotations

import os
import re
import time

import pandas as pd

_INFO = (
    '##INFO=<ID=SVTYPE,Number=1,Type=String,Description="Type of structural variant">\n'
    '##INFO=<ID=SVLEN,Number=1,Type=Integer,Description="Length of the SV">\n'
    '##INFO=<ID=END,Number=1,Type=Integer,Description="End position of the SV">\n'
    '##INFO=<ID=SUPPORT,Number=1,Type=Integer,Description="Number of reads supporting the structural variation">\n'
    '##INFO=<ID=RNAMES,Number=.,Type=String,Description="Names of supporting reads">\n'
    '##INFO=<ID=AF,Number=1,Type=Float,Description="Allele Frequency">\n'
)
_TOOLS = ('##fileformat=VCFv4.2\n##source=TDscope.1.0\n'
          '##FILTER=<ID=PASS,Description="All filters passed">\n')


def write_inner_header(fai_path: str, out_vcf: str, fasta: str):
    """generate_vcfheader equivalent (src/OutVCF.py:17-36)."""
    chroms = []
    with open(fai_path) as f:
        for line in f:
            p = line.split("\t")
            chroms.append((p[0], p[1]))
    with open(out_vcf, "w") as vcf:
        vcf.write(_TOOLS)
        now = time.strftime("%Y/%m/%d %H:%M:%S", time.localtime())
        vcf.write(f'##fileDate="{now}"\n')
        vcf.write(f"##reference={fasta}\n")
        for c, l in chroms:
            vcf.write(f"##contig=<ID={c},length={l}>\n")
        vcf.write('##ALT=<ID=INS,Description="Insertion">\n'
                  '##ALT=<ID=DEL,Description="Deletion">\n')
        vcf.write('##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n')
        vcf.write(_INFO)
    return out_vcf


def bed2vcf(raw_bed: str, somatic_bed: str, model_tsv: str, out_vcf: str,
            tumor_id: str, reference: str) -> str:
    """bed2vcf equivalent (src/OutVCF.py:38-77).

    Zero-call runs produce a header-only VCF (the reference crashes on the
    empty Somatic.bed read — handled gracefully here)."""
    if os.path.getsize(somatic_bed) == 0:
        write_inner_header(reference + ".fai", out_vcf, reference)
        with open(out_vcf, "a") as vcf:
            vcf.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\t"
                      f"FORMAT\t{tumor_id}\n")
        return out_vcf
    df_raw = pd.read_csv(raw_bed, sep="\t", header=None).drop_duplicates()
    df_raw["window"] = (df_raw[0] + "_" + df_raw[1].astype(str) + "-"
                        + df_raw[2].astype(str))
    df_raw.index = df_raw["window"]
    df_som = pd.read_csv(somatic_bed, sep="\t", header=None).drop_duplicates()
    df_som.index = df_som[3]
    df_model = pd.read_csv(model_tsv, sep="\t", index_col=0)
    write_inner_header(reference + ".fai", out_vcf, reference)
    with open(out_vcf, "a") as vcf:
        vcf.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                  f"{tumor_id}\n")
        for w in df_model.index:
            raw = df_raw.loc[w]
            som = df_som.loc[w]
            chrom, start, end = raw[0], str(raw[1]), raw[2]
            support_reads = som[4].split(";")[0]
            somatic_seq = ",".join(raw[3].split(";"))
            germline_seq = ",".join(raw[6].split(";"))
            svlen = int(som.iloc[-3])
            af = som.iloc[-2]
            yprob = df_model.loc[w, "yprob"]
            yhat = df_model.loc[w, "y_hat"]
            svtype = "MisAlign"
            if svlen >= 50:
                svtype = "INS"
            elif svlen <= -50:
                svtype = "DEL"
            info = (f"SVLEN={svlen};SVTYPE={svtype};END={end};"
                    f"SUPPORT={len(support_reads.split(','))};"
                    f"RNAMES={support_reads};AF={af};"
                    f"ConfidenceSV={yprob};DecisionSV={yhat}")
            vcf.write("\t".join([chrom, start, f"TDscope.{svtype}.{w}",
                                 germline_seq, somatic_seq, ".", "PASS",
                                 info, "GT", "0/1\n"]))
    return out_vcf


def merge_somatic_vcf(inner_vcf: str, interaln_vcf: str, out_path: str) -> str:
    """Final merge (src/SVscope.py:321-338): rebuilt header (INV/BND ALT
    lines injected before ##FORMAT), DecisionSV=True inner rows +
    InterALNSVs body, sorted by (chrom, pos)."""
    header = []
    body = []
    with open(inner_vcf) as f:
        for line in f:
            if line.startswith("#"):
                if "##FORMAT" in line:
                    header.append('##ALT=<ID=INV,Description="Invasion">\n'
                                  '##ALT=<ID=BND,Description="Translocation">\n'
                                  + line)
                else:
                    header.append(line)
            elif "True" in line:
                body.append(line)
    if os.path.exists(interaln_vcf):
        with open(interaln_vcf) as f:
            body.extend(l for l in f if not l.startswith("#"))
    body.sort(key=lambda l: (l.split("\t")[0], int(l.split("\t")[1])))
    with open(out_path, "w") as f:
        f.writelines(header)
        f.writelines(body)
    return out_path
