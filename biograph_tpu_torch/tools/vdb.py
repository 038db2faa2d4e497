"""VDB: a local variant warehouse (sqlite3 + the VDB filter language).

Copy of ``biograph_tpu/tools/vdb.py``; its exported VCFs name this package
in the ``##source=`` line.

Counterpart of the reference's VDB (python/biograph/vdb/: VCF -> parquet ->
AWS Athena SQL over S3).  This environment has no cloud egress, so the
warehouse is local: one sqlite3 database per VDB directory, with the same
logical tables (imported VCFs, annotation datasets, checkpointed studies)
and the same command surface:

    vdb vcf   import | list | export | delete | sort
    vdb anno  import | list | export | delete
    vdb study create | list | show | add | filter | export | revert |
              freeze | unfreeze | delete
    vdb query "SELECT ..."            (raw SQL, the Athena query analog)

Semantics mirror python/biograph/vdb/{vcf_cmd,anno_cmd,study_cmd}.py:
studies copy variants in at numbered *checkpoints*; `add` and `filter`
each create a new checkpoint (filter keeps the matching/non-matching rows
of the current one); `revert` rolls checkpoints back; frozen studies
reject mutation.  Filter expressions use the reference's bcftools-ish
grammar (tools/vdb_filter.py), including per-variant F_MISS and per-sample
SAMPLE_MISS missingness.

The flat `ingest/list_samples/query/export` functions at the bottom keep
the original VDB-lite API (older callers and tests) on the same store.
"""

from __future__ import annotations

import gzip
import json
import os
import re
import sqlite3
import time
import uuid as _uuid
from typing import Dict, Iterable, List, Tuple

_SCHEMA = """
CREATE TABLE IF NOT EXISTS vcfs(
  aid TEXT PRIMARY KEY, sample_name TEXT, description TEXT, refname TEXT,
  imported_on TEXT, record_count INTEGER, source TEXT);
CREATE TABLE IF NOT EXISTS variants(
  aid TEXT, sample_name TEXT, chrom TEXT, pos INTEGER, varend INTEGER,
  varid TEXT, ref TEXT, alt TEXT, qual REAL, filt TEXT, info TEXT,
  sample TEXT);
CREATE INDEX IF NOT EXISTS idx_var_aid ON variants(aid);
CREATE INDEX IF NOT EXISTS idx_var_site ON variants(chrom, pos);
CREATE TABLE IF NOT EXISTS annos(
  aid TEXT PRIMARY KEY, anno_name TEXT, version TEXT, imported_on TEXT,
  record_count INTEGER, source TEXT);
CREATE TABLE IF NOT EXISTS anno_data(
  aid TEXT, chrom TEXT, pos INTEGER, ref TEXT, alt TEXT, info TEXT);
CREATE INDEX IF NOT EXISTS idx_anno_site ON anno_data(aid, chrom, pos);
CREATE TABLE IF NOT EXISTS study_meta(
  study_name TEXT, key TEXT, value TEXT,
  PRIMARY KEY(study_name, key));
CREATE TABLE IF NOT EXISTS study_data(
  study_name TEXT, checkpoint INTEGER, aid TEXT, sample_name TEXT,
  chrom TEXT, pos INTEGER, varend INTEGER, varid TEXT, ref TEXT, alt TEXT,
  qual REAL, filt TEXT, info TEXT, sample TEXT);
CREATE INDEX IF NOT EXISTS idx_study ON study_data(study_name, checkpoint);
"""

_VAR_COLS = (
    "aid, sample_name, chrom, pos, varend, varid, ref, alt, qual, filt, "
    "info, sample"
)


def _now() -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())


def _natural_chrom_key(chrom: str):
    """1,2,...,10,...,22,X,Y,MT ordering (vcf_cmd.py:126 --chromosomal)."""
    c = chrom[3:] if chrom.lower().startswith("chr") else chrom
    return (0, int(c), "") if c.isdigit() else (1, 0, c)


def _parse_vcf(path: str):
    """Yield (sample_names, meta) first, then per-record dict rows.

    Handles single- and multi-sample VCFs; refname comes from ##refhash= or
    ##reference= headers when present (vcf_cmd.py add_import_args --refname
    'default: extract from input file')."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        samples: List[str] = []
        meta: Dict[str, str] = {}
        for line in f:
            line = line.rstrip("\n")
            if line.startswith("##"):
                m = re.match(r"##(refhash|reference)=(.*)", line)
                if m:
                    meta.setdefault("refname", m.group(2))
                continue
            if line.startswith("#CHROM"):
                cols = line.split("\t")
                samples = cols[9:] if len(cols) > 9 else []
                yield samples, meta
                break
        else:
            yield [], meta
            return
        for line in f:
            if not line.strip() or line.startswith("#"):
                continue
            fields = line.rstrip("\n").split("\t")
            chrom, pos, varid, ref, alt, qual, filt = fields[:7]
            info_d: Dict[str, object] = {}
            if len(fields) > 7 and fields[7] != ".":
                for item in fields[7].split(";"):
                    if "=" in item:
                        k, v = item.split("=", 1)
                        info_d[k] = v
                    else:
                        info_d[item] = True
            fmt_keys = fields[8].split(":") if len(fields) > 8 else []
            per_sample = []
            for si in range(len(samples)):
                vals = fields[9 + si].split(":") if len(fields) > 9 + si else []
                per_sample.append(dict(zip(fmt_keys, vals)))
            yield {
                "chrom": chrom,
                "pos": int(pos) - 1,  # stored 0-based (filter.py PosFix)
                "varend": int(pos) - 1 + len(ref),
                "varid": None if varid == "." else varid,
                "ref": ref,
                "alt": alt,
                "qual": None if qual == "." else float(qual),
                "filt": filt,
                "info": info_d,
                "samples": per_sample,
            }


class VDB:
    """One VDB directory = one sqlite3 warehouse."""

    def __init__(self, db_dir: str):
        os.makedirs(db_dir, exist_ok=True)
        self.dir = db_dir
        self.conn = sqlite3.connect(os.path.join(db_dir, "vdb.sqlite"))
        self.conn.executescript(_SCHEMA)

    def close(self):
        self.conn.close()

    # ---------------- vcf group (vcf_cmd.py) ----------------

    def import_vcf(
        self,
        path: str,
        sample: str | None = None,
        description: str = "",
        refname: str | None = None,
        aid: str | None = None,
        replace_sample: bool = False,
    ) -> Tuple[str, int]:
        """Import a VCF; returns (aid, record count).  Multi-sample VCFs
        import every sample column under the same aid."""
        it = _parse_vcf(path)
        samples, meta = next(it)
        if sample is not None:
            samples = samples or [sample]
            samples = [sample] + list(samples[1:])
        elif not samples:
            raise ValueError(f"{path}: no sample column; pass sample=")
        aid = aid or str(_uuid.uuid4())
        refname = refname or meta.get("refname", "")
        cur = self.conn.cursor()
        if replace_sample:
            old = [
                r[0]
                for r in cur.execute(
                    "SELECT aid FROM vcfs WHERE sample_name = ?", (samples[0],)
                )
            ]
            for o in old:
                cur.execute("DELETE FROM variants WHERE aid = ?", (o,))
                cur.execute("DELETE FROM vcfs WHERE aid = ?", (o,))
        n = 0
        rows = []
        for rec in it:
            for si, sname in enumerate(samples):
                rows.append(
                    (
                        aid,
                        sname,
                        rec["chrom"],
                        rec["pos"],
                        rec["varend"],
                        rec["varid"],
                        rec["ref"],
                        rec["alt"],
                        rec["qual"],
                        rec["filt"],
                        json.dumps(rec["info"]),
                        json.dumps(rec["samples"][si] if si < len(rec["samples"]) else {}),
                    )
                )
            n += 1
        cur.executemany(
            f"INSERT INTO variants({_VAR_COLS}) VALUES(?,?,?,?,?,?,?,?,?,?,?,?)",
            rows,
        )
        cur.execute(
            "INSERT INTO vcfs VALUES(?,?,?,?,?,?,?)",
            (aid, samples[0], description, refname, _now(), n, os.path.abspath(path)),
        )
        self.conn.commit()
        return aid, n

    def list_vcfs(self, sample_prefix: str | None = None) -> List[dict]:
        q = "SELECT aid, sample_name, refname, imported_on, record_count, description FROM vcfs"
        args: tuple = ()
        if sample_prefix:
            q += " WHERE sample_name LIKE ?"
            args = (sample_prefix + "%",)
        q += " ORDER BY sample_name, imported_on"
        return [
            dict(
                zip(
                    ("aid", "sample_name", "refname", "imported_on", "record_count", "description"),
                    r,
                )
            )
            for r in self.conn.execute(q, args)
        ]

    def export_vcf(self, aid: str, out_path: str) -> int:
        rows = list(
            self.conn.execute(
                f"SELECT {_VAR_COLS} FROM variants WHERE aid = ?"
                " ORDER BY chrom, pos, ref, alt",
                (aid,),
            )
        )
        if not rows:
            raise ValueError(f"no VCF with aid {aid}")
        sample = rows[0][1]
        self._write_vcf(out_path, [sample], _group_sites(rows, [sample]))
        return len(rows)

    def delete_vcf(self, *aids: str) -> int:
        cur = self.conn.cursor()
        n = 0
        for aid in aids:
            n += cur.execute("DELETE FROM variants WHERE aid = ?", (aid,)).rowcount > 0
            cur.execute("DELETE FROM vcfs WHERE aid = ?", (aid,))
        self.conn.commit()
        return n

    # ---------------- anno group (anno_cmd.py) ----------------

    def import_anno(
        self, path: str, name: str, version: str = "1", aid: str | None = None
    ) -> Tuple[str, int]:
        """Annotation dataset: INFO fields keyed by (chrom, pos, ref, alt);
        joined onto study exports with --anno."""
        it = _parse_vcf(path)
        next(it)
        aid = aid or str(_uuid.uuid4())
        rows = [
            (aid, rec["chrom"], rec["pos"], rec["ref"], rec["alt"], json.dumps(rec["info"]))
            for rec in it
        ]
        cur = self.conn.cursor()
        cur.executemany("INSERT INTO anno_data VALUES(?,?,?,?,?,?)", rows)
        cur.execute(
            "INSERT INTO annos VALUES(?,?,?,?,?,?)",
            (aid, name, version, _now(), len(rows), os.path.abspath(path)),
        )
        self.conn.commit()
        return aid, len(rows)

    def list_annos(self) -> List[dict]:
        return [
            dict(zip(("aid", "anno_name", "version", "imported_on", "record_count"), r))
            for r in self.conn.execute(
                "SELECT aid, anno_name, version, imported_on, record_count"
                " FROM annos ORDER BY anno_name, version"
            )
        ]

    def export_anno(self, aid_or_name: str, out_path: str) -> int:
        """Write an annotation dataset back out as VCF-like records
        (anno_cmd.py cmd_export)."""
        a = self.conn.execute(
            "SELECT aid FROM annos WHERE aid = ? OR anno_name = ?"
            " ORDER BY version DESC LIMIT 1",
            (aid_or_name, aid_or_name),
        ).fetchone()
        if not a:
            raise ValueError(f"no annotation {aid_or_name!r}")
        rows = self.conn.execute(
            "SELECT chrom, pos, ref, alt, info FROM anno_data WHERE aid = ?"
            " ORDER BY chrom, pos",
            (a[0],),
        ).fetchall()
        with open(out_path, "w") as f:
            f.write("##fileformat=VCFv4.2\n##source=biograph_tpu_torch vdb anno\n")
            f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
            for chrom, pos, ref, alt, info in rows:
                kv = json.loads(info)
                info_s = (
                    ";".join(
                        k if v is True else f"{k}={v}" for k, v in sorted(kv.items())
                    )
                    or "."
                )
                f.write(f"{chrom}\t{pos + 1}\t.\t{ref}\t{alt}\t.\t.\t{info_s}\n")
        return len(rows)

    def delete_anno(self, *aids: str) -> int:
        cur = self.conn.cursor()
        n = 0
        for aid in aids:
            n += cur.execute("DELETE FROM anno_data WHERE aid = ?", (aid,)).rowcount > 0
            cur.execute("DELETE FROM annos WHERE aid = ?", (aid,))
        self.conn.commit()
        return n

    # ---------------- study group (study_cmd.py) ----------------

    def _study_exists(self, study: str) -> bool:
        return (
            self.conn.execute(
                "SELECT 1 FROM study_meta WHERE study_name = ? LIMIT 1", (study,)
            ).fetchone()
            is not None
        )

    def _assert_study(self, study: str):
        if not self._study_exists(study):
            raise ValueError(f"study {study!r} does not exist")

    def _assert_unfrozen(self, study: str):
        if self.get_study_meta(study).get("frozen") == "1":
            raise ValueError(f"study {study!r} is frozen")

    def _set_meta(self, study: str, key: str, value: str):
        self.conn.execute(
            "INSERT OR REPLACE INTO study_meta VALUES(?,?,?)", (study, key, value)
        )

    def get_study_meta(self, study: str) -> Dict[str, str]:
        return dict(
            self.conn.execute(
                "SELECT key, value FROM study_meta WHERE study_name = ?", (study,)
            )
        )

    def current_checkpoint(self, study: str) -> int:
        r = self.conn.execute(
            "SELECT MAX(checkpoint) FROM study_data WHERE study_name = ?", (study,)
        ).fetchone()
        return r[0] or 0

    def create_study(self, study: str):
        if self._study_exists(study):
            raise ValueError(f"study {study!r} already exists")
        self._set_meta(study, "created_on", _now())
        self.conn.commit()

    def list_studies(self) -> List[Tuple[str, str]]:
        return list(
            self.conn.execute(
                "SELECT study_name, MAX(CASE WHEN key='created_on' THEN value END)"
                " FROM study_meta GROUP BY study_name ORDER BY study_name"
            )
        )

    def delete_study(self, study: str):
        self._assert_study(study)
        self.conn.execute("DELETE FROM study_data WHERE study_name = ?", (study,))
        self.conn.execute("DELETE FROM study_meta WHERE study_name = ?", (study,))
        self.conn.commit()

    def freeze_study(self, study: str, frozen: bool = True):
        self._assert_study(study)
        self._set_meta(study, "frozen", "1" if frozen else "0")
        self.conn.commit()

    def _new_checkpoint(self, study: str, description: str) -> int:
        c = self.current_checkpoint(study) + 1
        self._set_meta(study, f"checkpoint_{c}", description)
        return c

    def add_to_study(self, study: str, patterns: Iterable[str]):
        """Copy variants of matching imported VCFs into a new checkpoint.
        Patterns match sample names (with * wildcards) or exact aids
        (study_cmd.py cmd_add)."""
        self._assert_study(study)
        self._assert_unfrozen(study)
        patterns = list(patterns)
        cur = self.conn.cursor()
        aids: List[str] = []
        for pat in patterns:
            hit = [
                r[0]
                for r in cur.execute(
                    "SELECT aid FROM vcfs WHERE aid = ? OR sample_name GLOB ?",
                    (pat, pat),
                )
            ]
            if not hit:
                raise ValueError(f"no imported VCF matches {pat!r}")
            aids.extend(hit)
        # same-reference invariant (cmd_add: 'All variants in a study must
        # be called against the same reference')
        refnames = {
            r[0]
            for aid in aids
            for r in cur.execute("SELECT refname FROM vcfs WHERE aid = ?", (aid,))
        }
        meta = self.get_study_meta(study)
        known = meta.get("refname")
        refnames.discard("")
        if known:
            refnames.discard(known)
        if len(refnames) > (0 if known else 1):
            raise ValueError(f"mixed references in study {study!r}: {sorted(refnames)}")
        if not known and refnames:
            self._set_meta(study, "refname", refnames.pop())
        c = self._new_checkpoint(study, f"add {' '.join(patterns)}")
        prev = c - 1
        cur.execute(
            f"INSERT INTO study_data SELECT study_name, ?, {_VAR_COLS}"
            " FROM study_data WHERE study_name = ? AND checkpoint = ?",
            (c, study, prev),
        )
        for aid in aids:
            cur.execute(
                f"INSERT INTO study_data SELECT ?, ?, {_VAR_COLS}"
                " FROM variants WHERE aid = ?",
                (study, c, aid),
            )
        self.conn.commit()
        return c

    def copy_from_study(
        self, src: str, checkpoint: int | None, dst: str, patterns: Iterable[str]
    ):
        """study add --from SRC (study_cmd.py cmd_add)."""
        self._assert_study(src)
        self._assert_study(dst)
        self._assert_unfrozen(dst)
        patterns = list(patterns)
        cp = checkpoint or self.current_checkpoint(src)
        cur = self.conn.cursor()
        c = self._new_checkpoint(dst, f"add --from {src}@{cp} {' '.join(patterns)}")
        cur.execute(
            f"INSERT INTO study_data SELECT study_name, ?, {_VAR_COLS}"
            " FROM study_data WHERE study_name = ? AND checkpoint = ?",
            (c, dst, c - 1),
        )
        n = 0
        for pat in patterns:
            n += cur.execute(
                f"INSERT INTO study_data SELECT ?, ?, {_VAR_COLS}"
                " FROM study_data WHERE study_name = ? AND checkpoint = ?"
                " AND sample_name GLOB ?",
                (dst, c, src, cp, pat),
            ).rowcount
        if n == 0:
            raise ValueError(f"no samples in {src}@{cp} match {list(patterns)}")
        self.conn.commit()
        return c

    def show_study(self, study: str) -> dict:
        self._assert_study(study)
        meta = self.get_study_meta(study)
        cp = self.current_checkpoint(study)
        counts = list(
            self.conn.execute(
                "SELECT sample_name, COUNT(*) FROM study_data"
                " WHERE study_name = ? AND checkpoint = ?"
                " GROUP BY sample_name ORDER BY sample_name",
                (study, cp),
            )
        )
        return {"meta": meta, "checkpoint": cp, "samples": counts}

    def revert_study(self, study: str, checkpoint: int | None = None) -> int:
        self._assert_study(study)
        self._assert_unfrozen(study)
        cur_cp = self.current_checkpoint(study)
        if cur_cp == 0:
            raise ValueError(f"no checkpoints yet in study {study}")
        target = checkpoint if checkpoint is not None else cur_cp - 1
        if target < 0 or target >= cur_cp:
            raise ValueError(f"invalid target checkpoint {target} (max {cur_cp})")
        self.conn.execute(
            "DELETE FROM study_data WHERE study_name = ? AND checkpoint > ?",
            (study, target),
        )
        self.conn.execute(
            "DELETE FROM study_meta WHERE study_name = ? AND key LIKE 'checkpoint_%'"
            " AND CAST(SUBSTR(key, 12) AS INTEGER) > ?",
            (study, target),
        )
        self.conn.commit()
        return target

    def filter_study(self, study: str, expr: str, exclude: bool = False) -> Tuple[int, int]:
        """Apply a VDB filter expression; survivors land in a new checkpoint
        (study_cmd.py cmd_filter).  Returns (new checkpoint, rows kept)."""
        from biograph_tpu_torch.tools.vdb_filter import translate, uses_missingness

        self._assert_study(study)
        self._assert_unfrozen(study)
        cp = self.current_checkpoint(study)
        sql = translate(expr)
        keep = f"NOT ({sql})" if exclude else f"({sql})"
        cur = self.conn.cursor()
        src = "study_data"
        if uses_missingness(expr):
            # F_MISS: fraction of the study's samples with no called GT at a
            # site; SAMPLE_MISS: fraction of the study's sites missing for
            # the row's sample (filter.py generate_missingness_parser).
            # CREATE VIEW cannot carry bound parameters, so the two scalars
            # are inlined (study name escaped, checkpoint an int).
            cur.execute("DROP VIEW IF EXISTS study_miss")
            study_lit = "'" + study.replace("'", "''") + "'"
            cur.execute(
                f"""
                CREATE TEMP VIEW study_miss AS
                WITH cur AS (
                  SELECT *, (json_extract(sample, '$.GT') IS NULL
                             OR json_extract(sample, '$.GT') IN ('./.', '.'))
                         AS miss
                  FROM study_data
                  WHERE study_name = {study_lit} AND checkpoint = {int(cp)}
                ),
                ns AS (SELECT COUNT(DISTINCT sample_name) AS n FROM cur),
                nv AS (SELECT COUNT(DISTINCT chrom || ':' || pos || ':' || ref
                              || '>' || alt) AS n FROM cur),
                site AS (
                  SELECT chrom, pos, ref, alt,
                         (SELECT n FROM ns) - COUNT(*) + SUM(miss) AS nmiss
                  FROM cur GROUP BY chrom, pos, ref, alt
                ),
                smp AS (
                  SELECT sample_name,
                         (SELECT n FROM nv) - COUNT(*) + SUM(miss) AS nmiss
                  FROM cur GROUP BY sample_name
                )
                SELECT cur.*,
                       CAST(site.nmiss AS REAL) / (SELECT n FROM ns) AS f_miss,
                       CAST(smp.nmiss AS REAL) / (SELECT n FROM nv) AS sample_miss
                FROM cur
                JOIN site USING(chrom, pos, ref, alt)
                JOIN smp USING(sample_name)
                """
            )
            src = "study_miss"
        c = self._new_checkpoint(
            study, f"filter {'--exclude' if exclude else '--include'} {expr}"
        )
        if src == "study_miss":
            n = cur.execute(
                f"INSERT INTO study_data SELECT study_name, ?, {_VAR_COLS}"
                f" FROM study_miss WHERE {keep}",
                (c,),
            ).rowcount
        else:
            n = cur.execute(
                f"INSERT INTO study_data SELECT study_name, ?, {_VAR_COLS}"
                f" FROM study_data WHERE study_name = ? AND checkpoint = ?"
                f" AND {keep}",
                (c, study, cp),
            ).rowcount
        self.conn.commit()
        return c, n

    def export_study(
        self,
        study: str,
        out_path: str,
        checkpoint: int | None = None,
        anno: str | None = None,
        square_off: str | None = None,
        chromosomal: bool = False,
        fields: List[str] | None = None,
        no_header: bool = False,
    ) -> int:
        """Merge a study checkpoint into one multi-sample VCF
        (study_cmd.py cmd_export)."""
        self._assert_study(study)
        cp = checkpoint or self.current_checkpoint(study)
        rows = list(
            self.conn.execute(
                f"SELECT {_VAR_COLS} FROM study_data"
                " WHERE study_name = ? AND checkpoint = ?",
                (study, cp),
            )
        )
        samples = sorted({r[1] for r in rows})
        if square_off:
            if square_off not in samples:
                raise ValueError(
                    f"sample {square_off!r} not in {study} at checkpoint {cp}"
                )
            samples = [square_off]
        anno_map = {}
        if anno:
            a = self.conn.execute(
                "SELECT aid FROM annos WHERE anno_name = ? OR aid = ?"
                " ORDER BY version DESC LIMIT 1",
                (anno, anno),
            ).fetchone()
            if not a:
                raise ValueError(f"no annotation {anno!r}")
            anno_map = {
                (c2, p, rf, al): json.loads(i)
                for c2, p, rf, al, i in self.conn.execute(
                    "SELECT chrom, pos, ref, alt, info FROM anno_data WHERE aid = ?",
                    (a[0],),
                )
            }
        sites = _group_sites(rows, samples, chromosomal=chromosomal)
        if anno_map:
            sites = [
                (key, dict(info, **anno_map.get(key, {})), qual, filt, varid, persmp)
                for key, info, qual, filt, varid, persmp in sites
            ]
        return len(
            self._write_vcf(out_path, samples, sites, fields=fields, no_header=no_header)
        )

    # ---------------- query (query_cmd.py / Athena SQL analog) -----------

    def query(self, sql: str, params: tuple = ()) -> List[tuple]:
        head = sql.lstrip().split(None, 1)[0].upper() if sql.strip() else ""
        if head not in ("SELECT", "WITH"):
            raise ValueError("vdb query accepts SELECT statements only")
        return list(self.conn.execute(sql, params))

    # ---------------- writer ----------------

    def _write_vcf(self, out_path, samples, sites, fields=None, no_header=False):
        info_keys = sorted({k for _, info, *_ in sites for k in info})
        fmt_keys = sorted(
            {k for *_, persmp in sites for d in persmp.values() for k in d}
        )
        if fields:
            fmt_keys = [k for k in fmt_keys if k in fields]
        if "GT" in fmt_keys:  # GT first per VCF spec
            fmt_keys = ["GT"] + [k for k in fmt_keys if k != "GT"]
        with open(out_path, "w") as f:
            if not no_header:
                f.write("##fileformat=VCFv4.2\n##source=biograph_tpu_torch vdb\n")
                for k in info_keys:
                    f.write(
                        f'##INFO=<ID={k},Number=.,Type=String,Description="vdb">\n'
                    )
                for k in fmt_keys:
                    f.write(
                        f'##FORMAT=<ID={k},Number=.,Type=String,Description="vdb">\n'
                    )
                f.write(
                    "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                    + "\t".join(samples)
                    + "\n"
                )
            for (chrom, pos, ref, alt), info, qual, filt, varid, persmp in sites:
                info_s = (
                    ";".join(
                        k if v is True else f"{k}={v}" for k, v in sorted(info.items())
                    )
                    or "."
                )
                fmt_s = ":".join(fmt_keys) or "GT"
                cols = []
                for s in samples:
                    d = persmp.get(s)
                    if d is None:
                        cols.append("./." if fmt_keys[:1] == ["GT"] else ".")
                    else:
                        cols.append(
                            ":".join(str(d.get(k, ".")) for k in fmt_keys) or "."
                        )
                q = "." if qual is None else f"{qual:g}"
                f.write(
                    f"{chrom}\t{pos + 1}\t{varid or '.'}\t{ref}\t{alt}\t{q}\t"
                    f"{filt or '.'}\t{info_s}\t{fmt_s}\t" + "\t".join(cols) + "\n"
                )
        return sites


def _group_sites(rows, samples, chromosomal: bool = False):
    """variants/study rows -> per-site merged records.

    rows are _VAR_COLS tuples.  Returns a sorted list of
    ((chrom,pos,ref,alt), info, qual, filt, varid, {sample: fmt})."""
    sites: Dict[tuple, list] = {}
    for (_aid, sname, chrom, pos, _vend, varid, ref, alt, qual, filt, info, smp) in rows:
        key = (chrom, pos, ref, alt)
        ent = sites.get(key)
        if ent is None:
            ent = sites[key] = [json.loads(info), qual, filt, varid, {}]
        ent[4][sname] = json.loads(smp)
        if qual is not None and (ent[1] is None or qual > ent[1]):
            ent[1] = qual
    keyfn = (
        (lambda k: (_natural_chrom_key(k[0]), k[1], k[2], k[3]))
        if chromosomal
        else (lambda k: k)
    )
    return [
        (key, ent[0], ent[1], ent[2], ent[3], ent[4])
        for key, ent in sorted(sites.items(), key=lambda kv: keyfn(kv[0]))
    ]


def sort_vcf(in_path: str, out_path: str, chromosomal: bool = False) -> int:
    """`vdb vcf sort` analog (vcf_cmd.py:78): header preserved, records
    sorted by (chrom, pos) in alphabetic or natural chromosome order."""
    opener = gzip.open if in_path.endswith(".gz") else open
    header: List[str] = []
    recs: List[tuple] = []
    with opener(in_path, "rt") as f:
        for line in f:
            if line.startswith("#"):
                header.append(line)
            elif line.strip():
                c, p, _ = line.split("\t", 2)
                key = (_natural_chrom_key(c) if chromosomal else c, int(p))
                recs.append((key, line))
    recs.sort(key=lambda t: t[0])
    out_opener = gzip.open if out_path.endswith(".gz") else open
    with out_opener(out_path, "wt") as f:
        f.writelines(header)
        f.writelines(line for _, line in recs)
    return len(recs)


# ---------------- VDB-lite compatibility API ----------------


def ingest(db: str, vcf_path: str, sample: str) -> int:
    """Flat API: (re)import one VCF under a sample name."""
    v = VDB(db)
    try:
        _, n = v.import_vcf(vcf_path, sample=sample, replace_sample=True)
        return n
    finally:
        v.close()


def list_samples(db: str) -> Dict:
    v = VDB(db)
    try:
        return {
            r["sample_name"]: {
                "source": r["description"] or "",
                "records": r["record_count"],
                "ingested": r["imported_on"],
            }
            for r in v.list_vcfs()
        }
    finally:
        v.close()


def query(
    db: str,
    sample: str | None = None,
    chrom: str | None = None,
    pos_min: int | None = None,
    pos_max: int | None = None,
    min_qual: float | None = None,
    passing: bool = False,
) -> List[dict]:
    import numpy as np

    v = VDB(db)
    try:
        conds, args = ["1=1"], []
        if sample:
            conds.append("sample_name = ?")
            args.append(sample)
        if chrom:
            conds.append("chrom = ?")
            args.append(chrom)
        if pos_min is not None:
            conds.append("pos >= ?")
            args.append(pos_min - 1)
        if pos_max is not None:
            conds.append("pos <= ?")
            args.append(pos_max - 1)
        if min_qual is not None:
            conds.append("qual >= ?")
            args.append(min_qual)
        if passing:
            conds.append("filt = 'PASS'")
        rows = v.conn.execute(
            "SELECT sample_name, chrom, pos, ref, alt, qual, filt,"
            " json_extract(sample, '$.GT') FROM variants WHERE "
            + " AND ".join(conds)
            + " ORDER BY sample_name, chrom, pos",
            args,
        ).fetchall()
        return [
            {
                "sample": s,
                "chrom": c,
                "pos": p + 1,
                "ref": rf,
                "alt": al,
                "qual": float("nan") if q is None else q,
                "filter": fl,
                "gt": gt or ".",
            }
            for s, c, p, rf, al, q, fl, gt in rows
        ]
    finally:
        v.close()


def export(db: str, sample: str, out_path: str) -> int:
    v = VDB(db)
    try:
        aid = v.conn.execute(
            "SELECT aid FROM vcfs WHERE sample_name = ? ORDER BY imported_on DESC",
            (sample,),
        ).fetchone()
        if not aid:
            raise ValueError(f"no sample {sample!r} in {db}")
        return v.export_vcf(aid[0], out_path)
    finally:
        v.close()
