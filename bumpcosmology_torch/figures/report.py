"""Artifacts → figures → a compiled report (L6); counterpart of the JAX
package's ``figures/report.py``.

The reference ends in a showyourwork/tectonic manuscript (``ms.tex``) whose
figures are bound to pipeline scripts.  :func:`generate_report` turns a
finished pipeline run into the same kind of document:

* ``ms.tex`` — an article-class LaTeX source with the posterior summary
  tables and every drawn figure bound by ``\\includegraphics``;
* ``ms.md`` — the same content as Markdown;
* ``report.pdf`` — a multi-page PDF drawn with matplotlib (title and summary
  tables, then a page a figure), so a finished document exists without TeX.
"""
from __future__ import annotations

from pathlib import Path

__all__ = ["generate_report"]

_TITLE = "Calibrated Cosmography With a Physical Model of the Black Hole Mass Function"
_SUBTITLE = "bumpcosmology_torch pipeline report"
_COLUMNS = ["site", "mean", "sd", "90% CI", "R-hat", "ESS"]


def _trace_summary_rows(trace_path):
    from bumpcosmology_torch.utils.trace import load_trace

    return [(site, f"{s['mean']:.3f}", f"{s['sd']:.3f}", f"[{s['q5']:.3f}, {s['q95']:.3f}]", f"{s['rhat']:.3f}",
             f"{s['ess']:.0f}") for site, s in load_trace(trace_path).summary().items()]


def _tex_table(rows):
    head = "site & mean & sd & 90\\% CI & $\\hat R$ & ESS \\\\\\hline\n"
    body = "\n".join(" & ".join(r).replace("_", "\\_") + " \\\\" for r in rows)
    return "\\begin{tabular}{lrrrrr}\n\\hline\n" + head + body + "\n\\hline\n\\end{tabular}\n"


def _md_table(rows):
    out = ["| site | mean | sd | 90% CI | R-hat | ESS |", "|---|---|---|---|---|---|"]
    out += ["| " + " | ".join(r) + " |" for r in rows]
    return "\n".join(out)


def _write_pdf(pdf_path, sections, figures):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.image as mpimg
    import matplotlib.pyplot as plt
    from matplotlib.backends.backend_pdf import PdfPages

    with PdfPages(pdf_path) as pdf:
        fig = plt.figure(figsize=(8.5, 11))
        fig.text(0.5, 0.92, _TITLE, ha="center", fontsize=13, wrap=True)
        fig.text(0.5, 0.88, _SUBTITLE, ha="center", fontsize=10, style="italic")
        y = 0.82
        for name, rows in sections:
            fig.text(0.1, y, f"Posterior summary: {name}", fontsize=11, weight="bold")
            y -= 0.02
            ax = fig.add_axes([0.08, max(y - 0.023 * (len(rows) + 1), 0.03), 0.84, 0.023 * (len(rows) + 1)])
            ax.set_axis_off()
            table = ax.table(cellText=[list(r) for r in rows], colLabels=_COLUMNS, loc="center")
            table.auto_set_font_size(False)
            table.set_fontsize(7)
            y -= 0.024 * (len(rows) + 1) + 0.04
        pdf.savefig(fig)
        plt.close(fig)
        for f in figures:
            fig = plt.figure(figsize=(8.5, 11))
            ax = fig.add_axes([0.05, 0.08, 0.9, 0.84])
            ax.set_axis_off()
            ax.imshow(mpimg.imread(f))
            fig.text(0.5, 0.04, f.stem, ha="center", fontsize=10)
            pdf.savefig(fig)
            plt.close(fig)


def generate_report(cfg, out_dir="report", device=None):
    """Draw the figures (PNG) and write ``ms.tex``, ``ms.md`` and
    ``report.pdf`` under ``out_dir``; returns their paths.  ``device`` is
    where the bump curves are built (``None`` means CUDA)."""
    from bumpcosmology_torch.figures.plots import render_all

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    figures = render_all(cfg, out_dir=out_dir / "figures", skip_missing=True, fmt="png", device=device)

    sections = []
    for name, artifact in (("population fit", "trace.npz"), ("joint cosmology fit", "trace_cosmo.npz")):
        p = Path(cfg.paths.path(artifact))
        if p.exists():
            sections.append((name, _trace_summary_rows(p)))

    tex = ["\\documentclass{article}", "\\usepackage{graphicx}",
           f"\\title{{{_TITLE}\\\\\\large {_SUBTITLE}}}", "\\begin{document}\\maketitle"]
    for name, rows in sections:
        tex += [f"\\section*{{Posterior summary: {name}}}", _tex_table(rows)]
    for f in figures:
        stem = f.stem.replace("_", "\\_")
        tex += ["\\begin{figure}[p]\\centering", f"\\includegraphics[width=0.9\\textwidth]{{figures/{f.name}}}",
                f"\\caption{{{stem}}}\\end{{figure}}"]
    tex.append("\\end{document}")
    (out_dir / "ms.tex").write_text("\n".join(tex))

    md = [f"# {_TITLE}", f"*{_SUBTITLE}*", ""]
    for name, rows in sections:
        md += [f"## Posterior summary: {name}", "", _md_table(rows), ""]
    md += ["## Figures", ""] + [f"![{f.stem}](figures/{f.name})" for f in figures]
    (out_dir / "ms.md").write_text("\n".join(md))

    pdf_path = out_dir / "report.pdf"
    _write_pdf(pdf_path, sections, figures)
    return {"tex": out_dir / "ms.tex", "md": out_dir / "ms.md", "pdf": pdf_path}
