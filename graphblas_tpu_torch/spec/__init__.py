"""The executable specification of the port (``oracle``): dense numpy
mimics of every GraphBLAS op, which the tests hold the op layer against."""
