"""Entry points of the port (``serve``, ``train``) and its meshes
(``mesh``)."""
