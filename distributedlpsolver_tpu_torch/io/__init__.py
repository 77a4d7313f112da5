from distributedlpsolver_tpu_torch.io.mps import read_mps, read_mps_string, write_mps

__all__ = ["read_mps", "read_mps_string", "write_mps"]
