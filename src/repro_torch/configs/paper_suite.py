"""The paper's six OpenCL benchmark kernels (§IV, Fig. 7 / Table III),
reconstructed as OpenCL-C sources for our frontend.  Replication counts in
the paper's Fig. 7 are per-benchmark: chebyshev(16), sgfilter(10),
mibench(7), qspline(3), poly1(9), poly2(10).
"""

CHEBYSHEV = """
__kernel void chebyshev(__global int *A, __global int *B) {
  int idx = get_global_id(0);
  int x = A[idx];
  B[idx] = (x*(x*(16*x*x-20)*x+5));
}
"""

SGFILTER = """
__kernel void sgfilter(__global float *X, __global float *Y,
                       __global float *Out) {
  int idx = get_global_id(0);
  float x = X[idx];
  float y = Y[idx];
  float c0 = 2.0f; float c1 = 4.0f; float c2 = 59.0f;
  float t = c0*x*x + c1*x*y - c2*y*y + 3.0f*x - 7.0f*y + 1.0f;
  Out[idx] = t * x + t * y;
}
"""

MIBENCH = """
__kernel void mibench(__global float *A, __global float *B,
                      __global float *C) {
  int idx = get_global_id(0);
  float a = A[idx];
  float b = B[idx];
  float s = a*b + a + b;
  float t = a*a - b*b + 2.0f*s;
  C[idx] = s*t + 3.0f*s - 5.0f*t;
}
"""

QSPLINE = """
__kernel void qspline(__global float *T, __global float *P0,
                      __global float *P1, __global float *P2,
                      __global float *Q) {
  int idx = get_global_id(0);
  float t = T[idx];
  float p0 = P0[idx];
  float p1 = P1[idx];
  float p2 = P2[idx];
  float a = p0 - 2.0f*p1 + p2;
  float b = 2.0f*p1 - 2.0f*p0;
  Q[idx] = (a*t + b)*t + p0 + p1 - p0;
}
"""

POLY1 = """
__kernel void poly1(__global float *X, __global float *Y) {
  int idx = get_global_id(0);
  float x = X[idx];
  Y[idx] = ((3.0f*x + 5.0f)*x - 7.0f)*x + 9.0f;
}
"""

POLY2 = """
__kernel void poly2(__global float *X, __global float *Y) {
  int idx = get_global_id(0);
  float x = X[idx];
  float x2 = x*x;
  float x4 = x2*x2;
  Y[idx] = 2.0f*x4*x2 - 5.0f*x4 + 4.0f*x2 - 11.0f + 3.0f*x4*x - x2*x;
}
"""

# name -> (source, paper replication count, numpy oracle)
BENCHMARKS = {
    "chebyshev": (CHEBYSHEV, 16,
                  lambda x: x * (x * (16 * x * x - 20) * x + 5)),
    "sgfilter": (SGFILTER, 10,
                 lambda x, y: ((2 * x * x + 4 * x * y - 59 * y * y +
                                3 * x - 7 * y + 1) * x +
                               (2 * x * x + 4 * x * y - 59 * y * y +
                                3 * x - 7 * y + 1) * y)),
    "mibench": (MIBENCH, 7,
                lambda a, b: ((a * b + a + b) * (a * a - b * b +
                              2 * (a * b + a + b)) + 3 * (a * b + a + b) -
                              5 * (a * a - b * b + 2 * (a * b + a + b)))),
    "qspline": (QSPLINE, 3,
                lambda t, p0, p1, p2: (((p0 - 2 * p1 + p2) * t +
                                        (2 * p1 - 2 * p0)) * t + p0 +
                                       p1 - p0)),
    "poly1": (POLY1, 9,
              lambda x: ((3 * x + 5) * x - 7) * x + 9),
    "poly2": (POLY2, 10,
              lambda x: (2 * x ** 6 - 5 * x ** 4 + 4 * x * x - 11 +
                         3 * x ** 5 - x ** 3)),
}
