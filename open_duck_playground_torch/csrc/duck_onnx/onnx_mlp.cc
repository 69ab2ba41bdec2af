// Native ONNX policy inference runtime (the onnxruntime role in the
// reference's deployment path, onnx_infer.py:7-9). Parses the protobuf
// subset emitted by open_duck_playground_torch.export.onnx_export — float32
// tensors, ops {Sub, Div, Add, Mul, MatMul, Sigmoid, Tanh, Split} — and runs
// inference with zero dependencies. Exposed as a C ABI for ctypes.
//
// Built on the host at first use by cuda_build.build(..., host=True):
// g++ -O3 -march=native -fPIC -std=c++17 -shared, into build/host/.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <map>
#include <memory>
#include <string>
#include <vector>

namespace {

struct Tensor {
  std::vector<int64_t> dims;
  std::vector<float> data;
  size_t size() const {
    size_t n = 1;
    for (auto d : dims) n *= static_cast<size_t>(d);
    return n;
  }
};

struct Node {
  std::string op;
  std::vector<std::string> inputs, outputs;
  int64_t axis = 0;
  std::vector<int64_t> split;
};

struct Model {
  std::vector<Node> nodes;
  std::map<std::string, Tensor> initializers;
  std::string input_name, output_name;
};

class Reader {
 public:
  Reader(const uint8_t* p, size_t n) : p_(p), end_(p + n) {}
  bool done() const { return p_ >= end_; }
  uint64_t varint() {
    uint64_t v = 0;
    int shift = 0;
    while (p_ < end_) {
      uint8_t b = *p_++;
      v |= static_cast<uint64_t>(b & 0x7F) << shift;
      if (!(b & 0x80)) break;
      shift += 7;
    }
    return v;
  }
  // returns field number; wire type in *wire; for wire 2 sets *payload/*len
  uint32_t field(uint32_t* wire, const uint8_t** payload, size_t* len,
                 uint64_t* intval) {
    uint64_t key = varint();
    uint32_t f = static_cast<uint32_t>(key >> 3);
    *wire = static_cast<uint32_t>(key & 7);
    if (*wire == 0) {
      *intval = varint();
    } else if (*wire == 2) {
      uint64_t n = varint();
      *payload = p_;
      *len = static_cast<size_t>(n);
      p_ += n;
    } else if (*wire == 5) {
      std::memcpy(intval, p_, 4);
      p_ += 4;
    } else if (*wire == 1) {
      std::memcpy(intval, p_, 8);
      p_ += 8;
    }
    return f;
  }

 private:
  const uint8_t* p_;
  const uint8_t* end_;
};

Tensor parse_tensor(const uint8_t* buf, size_t n, std::string* name) {
  Tensor t;
  Reader r(buf, n);
  while (!r.done()) {
    uint32_t wire;
    const uint8_t* payload = nullptr;
    size_t len = 0;
    uint64_t iv = 0;
    uint32_t f = r.field(&wire, &payload, &len, &iv);
    if (f == 1 && wire == 0) {
      t.dims.push_back(static_cast<int64_t>(iv));
    } else if (f == 8 && wire == 2) {
      name->assign(reinterpret_cast<const char*>(payload), len);
    } else if (f == 9 && wire == 2) {
      t.data.resize(len / 4);
      std::memcpy(t.data.data(), payload, len);
    }
  }
  return t;
}

Node parse_node(const uint8_t* buf, size_t n) {
  Node node;
  Reader r(buf, n);
  while (!r.done()) {
    uint32_t wire;
    const uint8_t* payload = nullptr;
    size_t len = 0;
    uint64_t iv = 0;
    uint32_t f = r.field(&wire, &payload, &len, &iv);
    if (f == 1 && wire == 2) {
      node.inputs.emplace_back(reinterpret_cast<const char*>(payload), len);
    } else if (f == 2 && wire == 2) {
      node.outputs.emplace_back(reinterpret_cast<const char*>(payload), len);
    } else if (f == 4 && wire == 2) {
      node.op.assign(reinterpret_cast<const char*>(payload), len);
    } else if (f == 5 && wire == 2) {
      // AttributeProto
      Reader ar(payload, len);
      std::string aname;
      int64_t aint = 0;
      std::vector<int64_t> aints;
      while (!ar.done()) {
        uint32_t w2;
        const uint8_t* p2 = nullptr;
        size_t l2 = 0;
        uint64_t v2 = 0;
        uint32_t f2 = ar.field(&w2, &p2, &l2, &v2);
        if (f2 == 1 && w2 == 2) {
          aname.assign(reinterpret_cast<const char*>(p2), l2);
        } else if (f2 == 3 && w2 == 0) {
          aint = static_cast<int64_t>(v2);
        } else if (f2 == 8 && w2 == 0) {
          aints.push_back(static_cast<int64_t>(v2));
        }
      }
      if (aname == "axis") node.axis = aint;
      if (aname == "split") node.split = aints;
    }
  }
  return node;
}

std::string parse_value_info_name(const uint8_t* buf, size_t n) {
  Reader r(buf, n);
  while (!r.done()) {
    uint32_t wire;
    const uint8_t* payload = nullptr;
    size_t len = 0;
    uint64_t iv = 0;
    uint32_t f = r.field(&wire, &payload, &len, &iv);
    if (f == 1 && wire == 2)
      return std::string(reinterpret_cast<const char*>(payload), len);
  }
  return "";
}

bool parse_model(const uint8_t* buf, size_t n, Model* m) {
  const uint8_t* gbuf = nullptr;
  size_t glen = 0;
  {
    Reader r(buf, n);
    while (!r.done()) {
      uint32_t wire;
      const uint8_t* payload = nullptr;
      size_t len = 0;
      uint64_t iv = 0;
      uint32_t f = r.field(&wire, &payload, &len, &iv);
      if (f == 7 && wire == 2) {
        gbuf = payload;
        glen = len;
      }
    }
  }
  if (!gbuf) return false;
  Reader r(gbuf, glen);
  while (!r.done()) {
    uint32_t wire;
    const uint8_t* payload = nullptr;
    size_t len = 0;
    uint64_t iv = 0;
    uint32_t f = r.field(&wire, &payload, &len, &iv);
    if (f == 1 && wire == 2) {
      m->nodes.push_back(parse_node(payload, len));
    } else if (f == 5 && wire == 2) {
      std::string name;
      Tensor t = parse_tensor(payload, len, &name);
      m->initializers[name] = std::move(t);
    } else if (f == 11 && wire == 2) {
      m->input_name = parse_value_info_name(payload, len);
    } else if (f == 12 && wire == 2) {
      m->output_name = parse_value_info_name(payload, len);
    }
  }
  return true;
}

void matmul(const Tensor& a, const Tensor& b, Tensor* out) {
  int64_t m = a.dims[0], k = a.dims[1], n = b.dims[1];
  out->dims = {m, n};
  out->data.assign(static_cast<size_t>(m * n), 0.0f);
  for (int64_t i = 0; i < m; ++i)
    for (int64_t kk = 0; kk < k; ++kk) {
      float av = a.data[i * k + kk];
      const float* brow = &b.data[kk * n];
      float* orow = &out->data[i * n];
      for (int64_t j = 0; j < n; ++j) orow[j] += av * brow[j];
    }
}

// broadcast elementwise over trailing-compatible shapes (row vectors)
template <typename F>
void ewise(const Tensor& a, const Tensor& b, Tensor* out, F f) {
  out->dims = a.dims;
  out->data.resize(a.size());
  size_t bn = b.size();
  for (size_t i = 0; i < a.size(); ++i)
    out->data[i] = f(a.data[i], b.data[i % bn]);
}

}  // namespace

extern "C" {

void* duck_onnx_load(const char* path) {
  std::ifstream f(path, std::ios::binary);
  if (!f) return nullptr;
  std::vector<uint8_t> buf((std::istreambuf_iterator<char>(f)),
                           std::istreambuf_iterator<char>());
  auto* m = new Model();
  if (!parse_model(buf.data(), buf.size(), m)) {
    delete m;
    return nullptr;
  }
  return m;
}

int duck_onnx_infer(void* handle, const float* obs, int obs_n, float* out,
                    int out_n) {
  auto* m = static_cast<Model*>(handle);
  std::map<std::string, Tensor> vals;
  Tensor input;
  input.dims = {1, obs_n};
  input.data.assign(obs, obs + obs_n);
  vals[m->input_name] = std::move(input);
  for (const auto& n : m->nodes) {
    auto get = [&](const std::string& name) -> const Tensor& {
      auto it = vals.find(name);
      if (it != vals.end()) return it->second;
      return m->initializers.at(name);
    };
    const Tensor& a = get(n.inputs[0]);
    Tensor r;
    if (n.op == "MatMul") {
      matmul(a, get(n.inputs[1]), &r);
    } else if (n.op == "Add") {
      ewise(a, get(n.inputs[1]), &r, [](float x, float y) { return x + y; });
    } else if (n.op == "Sub") {
      ewise(a, get(n.inputs[1]), &r, [](float x, float y) { return x - y; });
    } else if (n.op == "Mul") {
      ewise(a, get(n.inputs[1]), &r, [](float x, float y) { return x * y; });
    } else if (n.op == "Div") {
      ewise(a, get(n.inputs[1]), &r, [](float x, float y) { return x / y; });
    } else if (n.op == "Sigmoid") {
      r.dims = a.dims;
      r.data.resize(a.size());
      for (size_t i = 0; i < a.size(); ++i)
        r.data[i] = 1.0f / (1.0f + std::exp(-a.data[i]));
    } else if (n.op == "Tanh") {
      r.dims = a.dims;
      r.data.resize(a.size());
      for (size_t i = 0; i < a.size(); ++i) r.data[i] = std::tanh(a.data[i]);
    } else if (n.op == "Split") {
      int64_t cols = a.dims[1];
      int64_t off = 0;
      for (size_t oi = 0; oi < n.outputs.size(); ++oi) {
        int64_t w = n.split.empty()
                        ? cols / static_cast<int64_t>(n.outputs.size())
                        : n.split[oi];
        Tensor part;
        part.dims = {a.dims[0], w};
        part.data.resize(static_cast<size_t>(a.dims[0] * w));
        for (int64_t row = 0; row < a.dims[0]; ++row)
          std::memcpy(&part.data[row * w], &a.data[row * cols + off],
                      static_cast<size_t>(w) * 4);
        vals[n.outputs[oi]] = std::move(part);
        off += w;
      }
      continue;
    } else {
      std::fprintf(stderr, "duck_onnx: unsupported op %s\n", n.op.c_str());
      return -1;
    }
    vals[n.outputs[0]] = std::move(r);
  }
  const Tensor& result = vals.at(m->output_name);
  if (static_cast<int>(result.size()) != out_n) return -2;
  std::memcpy(out, result.data.data(), static_cast<size_t>(out_n) * 4);
  return 0;
}

void duck_onnx_free(void* handle) { delete static_cast<Model*>(handle); }

}  // extern "C"
