"""A stand-in for a torch.distributed DeviceMesh in the port's CPU tests:
the axes and the device type, and no process group, which is enough for
every check that runs before a collective."""


class MeshOf:
    """MeshOf(genes=2, chains=2): the mesh's axis names and sizes."""

    device_type = "cpu"

    def __init__(self, **axes):
        self.mesh_dim_names, self._sizes = tuple(axes), tuple(axes.values())

    def size(self, i=None):
        return self._sizes[i]

    def get_group(self, name=None):
        raise AssertionError("no collective may run before the check under test")
