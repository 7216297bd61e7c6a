"""Entry points of the port (``serve``) and its meshes (``mesh``)."""
