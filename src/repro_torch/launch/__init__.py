"""Launchers of the LM substrate (``python -m repro_torch.launch.serve``,
``... .train``, ``... .dryrun``) and the dry-run's pieces: the meshes
(``mesh.py``), the cells' abstract inputs (``specs.py``) and the
roofline (``roofline.py``)."""
