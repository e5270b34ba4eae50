"""Launch tooling of the LM stack (port of ``repro.launch``): the
production mesh (``mesh``), the analytic per-cell cost model (``costs``)
and the dry run that traces a cell's step on ``meta`` stand-ins
(``dryrun``)."""
