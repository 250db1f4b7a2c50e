/*!
 * A C++ client of the PyTorch port's C ABI library: trains the
 * 784-128-64-10 MNIST MLP at batch 100 through MXExecutor* (the
 * cpp-package Executor) and the optimizer ABI (MXOptimizerCreateOptimizer /
 * MXOptimizerUpdate) on seeded synthetic MNIST-shaped data.
 *
 * Usage: capi_card_client <out_dir> <dev_type> <steps>
 *   dev_type 2 is the card, 1 the host.  Writes <out_dir>/init.bin (the
 *   parameters before the first update, in argument order), step1.bin
 *   (after it) and data.bin (the 10-class data, float32 X then y), so a
 *   Python check can replay the first update; prints the training
 *   accuracy and steps/s, and "CAPI CARD CLIENT PASSED" when the accuracy
 *   reaches 0.9.
 */
#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <random>
#include <string>
#include <vector>

#include "../../cpp-package/include/mxnet-cpp/MxNetCpp.hpp"

using namespace mxnet::cpp;

static void Write(const std::string &path, const std::vector<float> &v) {
  FILE *f = std::fopen(path.c_str(), "wb");
  if (f == nullptr || std::fwrite(v.data(), sizeof(float), v.size(), f) !=
                          v.size()) {
    std::fprintf(stderr, "FAIL: cannot write %s\n", path.c_str());
    std::exit(1);
  }
  std::fclose(f);
}

static void Ok(int rc, const char *what) {
  if (rc != 0) {
    std::fprintf(stderr, "FAIL: %s: %s\n", what, MXGetLastError());
    std::exit(1);
  }
}

static std::vector<float> Params(Executor *exec) {
  std::vector<float> all;
  for (const auto &name : exec->ArgNames()) {
    if (name == "data" || name == "softmax_label") continue;
    std::vector<float> v = exec->Arg(name).SyncCopyToCPU();
    all.insert(all.end(), v.begin(), v.end());
  }
  return all;
}

int main(int argc, char **argv) {
  if (argc < 4) {
    std::fprintf(stderr, "usage: %s out_dir dev_type steps\n", argv[0]);
    return 2;
  }
  const std::string out = argv[1];
  const int dev_type = std::atoi(argv[2]), steps = std::atoi(argv[3]);
  const int kN = 2000, kDim = 784, kClasses = 10, kBatch = 100;

  // 10 classes: a sparse stroke pattern a class (pixels in [0, 1]) plus
  // noise, the shape and range of MNIST
  std::mt19937 rng(14);
  std::uniform_real_distribution<float> unit(0.0f, 1.0f);
  std::vector<std::vector<float>> proto(kClasses, std::vector<float>(kDim));
  for (auto &p : proto)
    for (auto &v : p) v = unit(rng) < 0.15f ? 0.5f + 0.5f * unit(rng) : 0.0f;
  std::vector<float> X(kN * kDim), y(kN);
  for (int i = 0; i < kN; ++i) {
    int c = i % kClasses;
    y[i] = static_cast<float>(c);
    for (int d = 0; d < kDim; ++d) {
      float v = proto[c][d] + 0.3f * (unit(rng) - 0.5f);
      X[i * kDim + d] = v < 0.0f ? 0.0f : (v > 1.0f ? 1.0f : v);
    }
  }
  std::vector<float> both(X);
  both.insert(both.end(), y.begin(), y.end());
  Write(out + "/data.bin", both);

  Symbol data = Symbol::Variable("data");
  Symbol label = Symbol::Variable("softmax_label");
  Symbol fc1 = Operator("FullyConnected").SetParam("num_hidden", 128)
                   .SetInput("data", data).CreateSymbol("fc1");
  Symbol act1 = Operator("Activation").SetParam("act_type", "relu")
                    .SetInput("data", fc1).CreateSymbol("relu1");
  Symbol fc2 = Operator("FullyConnected").SetParam("num_hidden", 64)
                   .SetInput("data", act1).CreateSymbol("fc2");
  Symbol act2 = Operator("Activation").SetParam("act_type", "relu")
                    .SetInput("data", fc2).CreateSymbol("relu2");
  Symbol fc3 = Operator("FullyConnected").SetParam("num_hidden", kClasses)
                   .SetInput("data", act2).CreateSymbol("fc3");
  Symbol net = Operator("SoftmaxOutput").SetInput("data", fc3)
                   .SetInput("label", label).CreateSymbol("softmax");

  Context ctx(dev_type, 0);
  std::map<std::string, std::vector<mx_uint>> shapes = {
      {"data", {kBatch, kDim}}, {"softmax_label", {kBatch}}};
  Executor exec(net, ctx, shapes);
  Uniform init(0.07f, 3);
  for (const auto &name : exec.ArgNames()) {
    if (name == "data" || name == "softmax_label") continue;
    init(name, &exec.Arg(name));
  }
  Write(out + "/init.bin", Params(&exec));

  OptimizerCreator creator;
  Ok(MXOptimizerFindCreator("sgd", &creator), "MXOptimizerFindCreator");
  const char *keys[] = {"momentum", "rescale_grad"};
  std::string rescale = std::to_string(1.0 / kBatch);
  const char *vals[] = {"0.9", rescale.c_str()};
  OptimizerHandle opt;
  Ok(MXOptimizerCreateOptimizer(creator, 2, keys, vals, &opt),
     "MXOptimizerCreateOptimizer");

  const auto &names = exec.ArgNames();
  auto step = [&](int lo) {
    exec.Arg("data").SyncCopyFromCPU(std::vector<float>(
        X.begin() + lo * kDim, X.begin() + (lo + kBatch) * kDim));
    exec.Arg("softmax_label").SyncCopyFromCPU(std::vector<float>(
        y.begin() + lo, y.begin() + lo + kBatch));
    exec.Forward(true);
    exec.Backward();
    for (size_t i = 0; i < names.size(); ++i) {
      if (exec.GradReq()[i] == 0) continue;
      Ok(MXOptimizerUpdate(opt, static_cast<int>(i), exec.Args()[i].handle(),
                           exec.Grads()[i].handle(), 0.1f, 0.0f),
         "MXOptimizerUpdate");
    }
  };
  step(0);
  Write(out + "/step1.bin", Params(&exec));

  auto t0 = std::chrono::steady_clock::now();
  for (int s = 1; s < steps; ++s) step((s * kBatch) % kN);
  NDArray::WaitAll();
  double secs = std::chrono::duration<double>(
      std::chrono::steady_clock::now() - t0).count();

  Accuracy acc;
  for (int lo = 0; lo + kBatch <= kN; lo += kBatch) {
    exec.Arg("data").SyncCopyFromCPU(std::vector<float>(
        X.begin() + lo * kDim, X.begin() + (lo + kBatch) * kDim));
    exec.Forward(false);
    std::vector<float> probs = exec.Outputs()[0].SyncCopyToCPU();
    acc.Update(std::vector<float>(y.begin() + lo, y.begin() + lo + kBatch),
               probs, kClasses);
  }
  int ctx_type = 0, ctx_id = -1;
  Ok(MXNDArrayGetContext(exec.Arg("fc1_weight").handle(), &ctx_type,
                         &ctx_id), "MXNDArrayGetContext");
  Ok(MXOptimizerFree(opt), "MXOptimizerFree");
  std::printf("CLIENT steps %d steps_s %.3f accuracy %.4f context %d %d\n",
              steps, (steps - 1) / secs, acc.Get(), ctx_type, ctx_id);
  if (acc.Get() < 0.9f || ctx_type != dev_type) {
    std::fprintf(stderr, "FAIL: accuracy %.4f (< 0.9?) or context %d\n",
                 acc.Get(), ctx_type);
    return 1;
  }
  std::printf("CAPI CARD CLIENT PASSED\n");
  return 0;
}
