"""One reader per metric, found by the metric's name: `metrics/<name>.py`,
or the file of the name's part before its first dot, defines
`read(res, ctx)`, which returns the number, or None when the run has
nothing for it to read (a per-layer metric in an untraced run)."""
