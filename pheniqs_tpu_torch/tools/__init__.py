"""The port's tools: the measurement tools (the host-pipeline ladder, the
decode-step ablation ladder, the panel-memory curve, the multi-card bench),
the partial-merge tool, and copies of the reference's companion tools
(``prior``, ``io``, ``illumina``, ``configuration``, ``transcode``,
``cram_manifest``, ``json_lint``) that run on the port's own job and
compiler."""
