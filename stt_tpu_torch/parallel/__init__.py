"""Data parallelism across processes (the counterpart of `stt_tpu.parallel`,
its data axis): `distributed` joins the process group and merges what the
ranks compute, `mesh` splits the batch over the ranks."""

from stt_tpu_torch.parallel.mesh import DataMesh, make_mesh

__all__ = ["DataMesh", "make_mesh"]
