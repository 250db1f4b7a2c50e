
extern "C" __global__ void softmax_grad(const float* y, const float* l, float* dx) {
const int y_ndim = 2;
const int y_dims[] = {37, 1000};
const int l_ndim = 1;
const int l_dims[] = {37};
const int dx_ndim = 2;
const int dx_dims[] = {37, 1000};
  int i = blockIdx.x, j = threadIdx.x;
  for (; j < y_dims[1]; j += blockDim.x)
    dx[i * y_dims[1] + j] = y[i * y_dims[1] + j] - (j == (int)l[i]);
}
