from . import bounds, cholesky, compiler, emit_cuda, interp, real, vec
from .real import (Real, Constant, Parameter, VectorParameter, Column,
                   IntColumn, MatColumn, const, to_real, parameter,
                   vector_parameter, sum_, log_sum_exp, eq, lt, gt, lte,
                   gte, compare, lookup, zero, one, two, neg_one, pi,
                   infinity, neg_infinity)
from .vec import Vec
from .compiler import CompiledDensity

__all__ = [
    "bounds", "cholesky", "compiler", "emit_cuda", "interp", "real", "vec",
    "Real", "Constant", "Parameter", "VectorParameter", "Column", "IntColumn",
    "MatColumn", "const", "to_real", "parameter", "vector_parameter",
    "sum_", "log_sum_exp", "eq", "lt", "gt", "lte", "gte", "compare",
    "lookup", "zero", "one", "two", "neg_one", "pi", "infinity",
    "neg_infinity", "Vec", "CompiledDensity",
]
