"""Post-hoc VCF adjustment: tandem-repeat INS dedupe + chrM drop.

Re-implements reference src/CheckInner-alignmentSVs.adjustVCF.py: map
RepeatMasker-window INS calls onto de-novo span-window calls (full
containment, `bedtools intersect -F 1.0`), then keep the RepeatMasker
representation of duplicated insertions, dedupe DEL by UUID, and drop chrM
records into <sample>_tumor.mergedSomatic.adjusted.vcf.
"""
from __future__ import annotations

import os
import re



def _parse_uuid_region(uuid: str):
    """UUID region 'chrom_start-end' -> (chrom, start, end).

    Split from the right: contig names may themselves contain '_' or '-'
    (GRCh38 alts/randoms like chrUn_KI270302v1)."""
    region = uuid.split(".")[-1]
    head, end = region.rsplit("-", 1)
    chrom, start = head.rsplit("_", 1)
    return chrom, int(start), int(end)


def adjust_tandem_repeat_ins(savedir: str, merged_vcf: str,
                             lc_somatic_bed: str):
    """AdjustTandemRepeatINS equivalent (:22-56): pairs of
    (LC window UUID, span window UUID) where the LC window fully contains
    the called INS window."""
    ins_regions = []
    with open(merged_vcf) as f:
        for line in f:
            if line.startswith("#"):
                continue
            uuid = line.split("\t")[2]
            if uuid.split(".")[1] == "INS":
                ins_regions.append(_parse_uuid_region(uuid))
    pairs = []
    if os.path.exists(lc_somatic_bed) and ins_regions:
        lc_rows = [l.split("\t") for l in
                   open(lc_somatic_bed).read().splitlines() if l.strip()]
        for lc in lc_rows:
            lc_chrom, lc_s, lc_e = lc[0], int(lc[1]), int(lc[2])
            lc_type = lc[5] if len(lc) > 5 else "INS"
            for (c, s, e) in ins_regions:
                if c == lc_chrom and lc_s <= s and e <= lc_e and e > s - 1:
                    lcuuid = f"TDscope.{lc_type}.{lc_chrom}_{lc_s}-{lc_e}"
                    spanuuid = f"TDscope.INS.{c}_{s}-{e}"
                    pairs.append((lcuuid, spanuuid))
    return pairs


def adjust_vcf(savedir: str, sample_id: str | None = None,
               exclude_chrom: str = "chrM") -> str:
    """VcfWindowLoading equivalent (:58-101)."""
    sample_id = sample_id or os.path.basename(os.path.abspath(savedir))
    merged = os.path.join(savedir, f"{sample_id}_tumor.mergedSomatic.vcf")
    if not os.path.exists(merged):
        # the reference derives the name from the savedir basename; fall
        # back to any *.mergedSomatic.vcf present
        cands = [x for x in os.listdir(savedir)
                 if x.endswith(".mergedSomatic.vcf")]
        if not cands:
            raise FileNotFoundError(f"no mergedSomatic.vcf in {savedir}")
        merged = os.path.join(savedir, cands[0])
    lc_bed = os.path.join(savedir,
                          "CandidateSpan.tumorLC.merged.decision.somatic.bed")
    pairs = adjust_tandem_repeat_ins(savedir, merged, lc_bed)
    tri_uuid = {a for a, _ in pairs}
    tri_small = {b for _, b in pairs}
    header, records = [], []
    written = set()
    with open(merged) as f:
        for line in f:
            if line.startswith("#"):
                header.append(line)
                continue
            uuid = line.split("\t")[2]
            if re.search(exclude_chrom, uuid):
                continue
            sv_type = uuid.split(".")[1]
            if sv_type == "INS":
                if uuid in tri_uuid and uuid not in written:
                    records.append(line)
                    written.add(uuid)
                elif uuid not in tri_small and uuid not in written:
                    records.append(line)
                    written.add(uuid)
            elif sv_type == "DEL":
                if uuid not in written:
                    records.append(line)
                    written.add(uuid)
            else:
                records.append(line)
    out = merged.replace(".mergedSomatic.vcf", ".mergedSomatic.adjusted.vcf")
    with open(out, "w") as f:
        f.writelines(header + records)
    return out
