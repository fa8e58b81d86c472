"""Host tools for the port's runs: the snapshot viewer
(``python -m rigid_body_2d_3d_pysph_tpu_torch.tools.view_snapshots``)
and the post-processing figures
(``python -m rigid_body_2d_3d_pysph_tpu_torch.tools.plot_results``).
Each imports ``matplotlib`` where it draws, so the package itself never
needs it."""
