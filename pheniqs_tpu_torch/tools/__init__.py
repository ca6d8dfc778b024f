"""Measurement tools: the host-pipeline ladder, the decode-step ablation ladder, the panel-memory curve."""
