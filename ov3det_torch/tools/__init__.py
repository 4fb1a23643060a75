"""The offline open-vocabulary tools of the port: pseudo-label writing,
2D->3D lifting, pseudo-box evaluation, ScanNet readers and format tools.

A copy of `ov3det/tools/` (numpy only), apart from
`extract_class_features`, which runs the port's CLIP text tower.  Import
each from its module.
"""
