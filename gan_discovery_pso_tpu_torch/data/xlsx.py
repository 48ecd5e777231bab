"""Minimal .xlsx manifest I/O on zipfile and ElementTree, no package
needed (the port's own copy of `gan_discovery_pso_tpu/data/xlsx.py`:
`read_xlsx` :32, `write_xlsx` :120, `read_manifest` :196; the same code, so
every XML member it writes is byte-equal to the JAX writer's).

The reference drivers read patient and box manifests with
pandas.read_excel (reference src/data/dataset_preparation.py:81-86), which
needs openpyxl. This module implements the subset the manifests need on
the OOXML container: one worksheet, inline numbers and shared strings, the
first row the header. Values come back as str or float; callers coerce.
"""

from __future__ import annotations

import numbers
import re
import zipfile
from pathlib import Path
from xml.etree import ElementTree as ET
from xml.sax.saxutils import escape

_NS = "{http://schemas.openxmlformats.org/spreadsheetml/2006/main}"


def _col_index(cell_ref: str) -> int:
    """'B7' → 1 (zero-based column)."""
    letters = re.match(r"([A-Z]+)", cell_ref).group(1)
    idx = 0
    for ch in letters:
        idx = idx * 26 + (ord(ch) - ord("A") + 1)
    return idx - 1


def read_xlsx(path: str | Path) -> dict[str, list]:
    """First worksheet → {column_name: [values]} (header row = names).

    Numeric cells come back as float, shared/inline strings as str, empty
    cells as None."""
    with zipfile.ZipFile(path) as zf:
        shared: list[str] = []
        if "xl/sharedStrings.xml" in zf.namelist():
            root = ET.fromstring(zf.read("xl/sharedStrings.xml"))
            for si in root.iter(f"{_NS}si"):
                shared.append("".join(t.text or "" for t in si.iter(f"{_NS}t")))
        # lowest-numbered sheet, not zip-entry order (multi-sheet workbooks
        # may store entries in arbitrary order)
        sheets = [n for n in zf.namelist()
                  if re.match(r"xl/worksheets/sheet\d+\.xml$", n)]
        if not sheets:
            raise ValueError(f"no worksheet found in {path}")
        sheet_name = min(
            sheets, key=lambda n: int(re.search(r"sheet(\d+)\.xml$", n).group(1))
        )
        root = ET.fromstring(zf.read(sheet_name))

    rows: list[dict[int, object]] = []
    for row in root.iter(f"{_NS}row"):
        vals: dict[int, object] = {}
        # the c element's r= attribute is OPTIONAL in OOXML: without it the
        # cell sits one column right of the previous cell in the row (several
        # streaming writers omit it) — track the running column index instead
        # of defaulting to A1, which would pile every such cell onto column 0
        col = -1
        for c in row.iter(f"{_NS}c"):
            ref = c.get("r")
            col = _col_index(ref) if ref else col + 1
            t = c.get("t")
            v = c.find(f"{_NS}v")
            if t == "inlineStr":
                is_el = c.find(f"{_NS}is")
                text = "".join(tt.text or "" for tt in is_el.iter(f"{_NS}t")) if is_el is not None else ""
                vals[col] = text
            elif v is None:
                continue
            elif t == "s":
                vals[col] = shared[int(v.text)]
            elif t == "str":
                vals[col] = v.text
            elif t == "e" or v.text is None:
                # error-type cells (#DIV/0!) and empty <v/> elements carry
                # no usable value — treat like a missing cell rather than
                # aborting the whole manifest on float('#DIV/0!')
                continue
            else:
                vals[col] = float(v.text)
        rows.append(vals)

    if not rows:
        return {}
    header_cells = rows[0]
    if not header_cells:
        # styled-but-empty first rows serialize as `<row r="1"/>`; a bare
        # max()-of-empty ValueError deep in a preprocess run is useless
        raise ValueError(
            f"{path}: the first worksheet row is empty — manifests must "
            "carry their column names in row 1"
        )
    ncols = max(header_cells) + 1
    names = [str(header_cells.get(i, f"col{i}")) for i in range(ncols)]
    if len(set(names)) != len(names):
        dupes = sorted({n for n in names if names.count(n) > 1})
        raise ValueError(
            f"{path}: duplicate header column(s) {dupes} — a shared dict key "
            "would silently interleave two columns' values"
        )
    out: dict[str, list] = {n: [] for n in names}
    for r in rows[1:]:
        for i, n in enumerate(names):
            out[n].append(r.get(i))
    return out


def _cell_ref(row: int, col: int) -> str:
    letters = ""
    col += 1
    while col:
        col, rem = divmod(col - 1, 26)
        letters = chr(ord("A") + rem) + letters
    return f"{letters}{row + 1}"


def write_xlsx(path: str | Path, columns: dict[str, list]) -> Path:
    """{name: [values]} → a minimal single-sheet .xlsx (inline strings)."""
    names = list(columns)
    nrows = max((len(v) for v in columns.values()), default=0)

    def cell_xml(r, c, value):
        ref = _cell_ref(r, c)
        if value is None:
            return ""
        # numbers.Real (not bare int/float) so numpy scalars — np.int64,
        # np.float32, ... — also round-trip as numeric cells, not strings
        if isinstance(value, numbers.Real) and not isinstance(value, bool):
            # xsd:double has no nan/inf literal — Excel treats <v>nan</v> as
            # a corrupt workbook; write non-finite metrics as empty cells
            # (e.g. CvEvaluator folds with tp+fp==0 emit nan precision)
            if value != value or value in (float("inf"), float("-inf")):
                return ""
            return f'<c r="{ref}"><v>{value}</v></c>'
        text = escape(str(value))
        return f'<c r="{ref}" t="inlineStr"><is><t>{text}</t></is></c>'

    body = ['<row r="1">' + "".join(cell_xml(0, c, n) for c, n in enumerate(names)) + "</row>"]
    for r in range(nrows):
        cells = "".join(
            cell_xml(r + 1, c, columns[n][r] if r < len(columns[n]) else None)
            for c, n in enumerate(names)
        )
        body.append(f'<row r="{r + 2}">{cells}</row>')

    sheet = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<worksheet xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main">'
        "<sheetData>" + "".join(body) + "</sheetData></worksheet>"
    )
    workbook = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<workbook xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main" '
        'xmlns:r="http://schemas.openxmlformats.org/officeDocument/2006/relationships">'
        '<sheets><sheet name="Sheet1" sheetId="1" r:id="rId1"/></sheets></workbook>'
    )
    wb_rels = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">'
        '<Relationship Id="rId1" '
        'Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/worksheet" '
        'Target="worksheets/sheet1.xml"/></Relationships>'
    )
    root_rels = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">'
        '<Relationship Id="rId1" '
        'Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/officeDocument" '
        'Target="xl/workbook.xml"/></Relationships>'
    )
    content_types = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<Types xmlns="http://schemas.openxmlformats.org/package/2006/content-types">'
        '<Default Extension="rels" '
        'ContentType="application/vnd.openxmlformats-package.relationships+xml"/>'
        '<Default Extension="xml" ContentType="application/xml"/>'
        '<Override PartName="/xl/workbook.xml" ContentType='
        '"application/vnd.openxmlformats-officedocument.spreadsheetml.sheet.main+xml"/>'
        '<Override PartName="/xl/worksheets/sheet1.xml" ContentType='
        '"application/vnd.openxmlformats-officedocument.spreadsheetml.worksheet+xml"/>'
        "</Types>"
    )
    path = Path(path)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("[Content_Types].xml", content_types)
        zf.writestr("_rels/.rels", root_rels)
        zf.writestr("xl/workbook.xml", workbook)
        zf.writestr("xl/_rels/workbook.xml.rels", wb_rels)
        zf.writestr("xl/worksheets/sheet1.xml", sheet)
    return path


def read_manifest(path: str | Path) -> dict[str, list]:
    """Manifest reader: .xlsx via read_xlsx, .csv via the csv module —
    both → {column: [values]}."""
    path = Path(path)
    if path.suffix == ".xlsx":
        return read_xlsx(path)
    import csv

    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        cols: dict[str, list] = {n: [] for n in reader.fieldnames or []}
        for row in reader:
            for n in cols:
                cols[n].append(row[n])
    return cols
