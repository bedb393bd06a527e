"""Minimal dependency-free .xlsx writer (one sheet, inline strings; a
copy of ``merlin_tpu/utils/xlsx.py``).

The reference ships MMBench predictions as ``mmbench.xlsx`` via
pandas/openpyxl (mmgpt/engine/eval/eval_mmbench.py:173); neither is a
dependency of the port, and the MMBench submission server wants xlsx —
so the format is written directly. An .xlsx file is just a zip of
five small XML parts; numbers are stored as numeric cells, everything
else as ``inlineStr`` (no sharedStrings table needed).
"""

from __future__ import annotations

import zipfile
from typing import Dict, List, Optional, Sequence
from xml.sax.saxutils import escape

_CONTENT_TYPES = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Types xmlns="http://schemas.openxmlformats.org/package/2006/content-types">
<Default Extension="rels" ContentType="application/vnd.openxmlformats-package.relationships+xml"/>
<Default Extension="xml" ContentType="application/xml"/>
<Override PartName="/xl/workbook.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.sheet.main+xml"/>
<Override PartName="/xl/worksheets/sheet1.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.worksheet+xml"/>
</Types>"""

_RELS = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">
<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/officeDocument" Target="xl/workbook.xml"/>
</Relationships>"""

_WORKBOOK = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<workbook xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main" xmlns:r="http://schemas.openxmlformats.org/officeDocument/2006/relationships">
<sheets><sheet name="Sheet1" sheetId="1" r:id="rId1"/></sheets>
</workbook>"""

_WORKBOOK_RELS = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">
<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/worksheet" Target="worksheets/sheet1.xml"/>
</Relationships>"""


def _col_name(i: int) -> str:
    """0 -> A, 25 -> Z, 26 -> AA ..."""
    out = ""
    i += 1
    while i:
        i, rem = divmod(i - 1, 26)
        out = chr(ord("A") + rem) + out
    return out


def _cell(ref: str, value) -> str:
    if value is None:
        return ""
    if isinstance(value, bool):
        return f'<c r="{ref}" t="b"><v>{int(value)}</v></c>'
    if isinstance(value, (int, float)):
        return f'<c r="{ref}"><v>{value}</v></c>'
    text = escape(str(value))
    return f'<c r="{ref}" t="inlineStr"><is><t xml:space="preserve">{text}</t></is></c>'


def write_xlsx(path: str, rows: Sequence[Sequence], *,
               header: Optional[Sequence[str]] = None) -> None:
    """Write rows (lists of str/num/None) to a single-sheet .xlsx."""
    all_rows: List[Sequence] = ([list(header)] if header else []) + [
        list(r) for r in rows]
    body = []
    for ri, row in enumerate(all_rows, start=1):
        cells = "".join(_cell(f"{_col_name(ci)}{ri}", v)
                        for ci, v in enumerate(row))
        body.append(f'<row r="{ri}">{cells}</row>')
    sheet = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>\n'
        '<worksheet xmlns="http://schemas.openxmlformats.org/'
        'spreadsheetml/2006/main"><sheetData>'
        + "".join(body) + "</sheetData></worksheet>")
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("[Content_Types].xml", _CONTENT_TYPES)
        z.writestr("_rels/.rels", _RELS)
        z.writestr("xl/workbook.xml", _WORKBOOK)
        z.writestr("xl/_rels/workbook.xml.rels", _WORKBOOK_RELS)
        z.writestr("xl/worksheets/sheet1.xml", sheet)


def write_records_xlsx(path: str, records: Sequence[Dict],
                       columns: Optional[Sequence[str]] = None) -> None:
    """Write a list of dicts; columns default to first-seen key order."""
    if columns is None:
        columns = []
        for rec in records:
            for k in rec:
                if k not in columns:
                    columns.append(k)
    rows = [[rec.get(c) for c in columns] for rec in records]
    write_xlsx(path, rows, header=columns)


def read_xlsx(path: str) -> List[Dict]:
    """Tiny reader for round-trip tests: inline-string/number cells of
    sheet1 back to dicts keyed by the header row."""
    import re

    with zipfile.ZipFile(path) as z:
        xml = z.read("xl/worksheets/sheet1.xml").decode()
    rows = []
    for row_xml in re.findall(r"<row[^>]*>(.*?)</row>", xml, re.S):
        cells = {}
        for ref, attrs, inner in re.findall(
                r'<c r="([A-Z]+\d+)"([^>]*)>(.*?)</c>', row_xml, re.S):
            col = re.match(r"[A-Z]+", ref).group(0)
            m = re.search(r"<t[^>]*>(.*?)</t>", inner, re.S)
            if m is not None and 't="inlineStr"' in attrs:
                from xml.sax.saxutils import unescape

                cells[col] = unescape(m.group(1))
            else:
                v = re.search(r"<v>(.*?)</v>", inner, re.S)
                if v:
                    num = float(v.group(1))
                    cells[col] = int(num) if num == int(num) else num
        rows.append(cells)
    if not rows:
        return []
    header = rows[0]
    cols = sorted(header, key=lambda c: (len(c), c))
    out = []
    for row in rows[1:]:
        out.append({header[c]: row.get(c) for c in cols if c in header})
    return out
