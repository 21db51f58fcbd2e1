// Dual numbers (value, tangent) for forward-mode derivatives on the card.
//
// Instantiating the recursions of rbd.cuh and staged.cuh on Dual<T> turns
// each into its JVP along the tangent the inputs are seeded with, without a
// second copy of the code: the second-order kernels (so.cu) are the ∇FD
// body and the staged stage bodies run on Dual<T>. Constants of the robot
// stay of type T (base_t<Dual<T>> is T, rbd.cuh), so a product with one
// costs two multiplications, a sum with one one addition. The tangent
// rules are those of torch.func.jvp (d(a·b) = da·b + a·db,
// d(a/b) = (da − (a/b)·db)/b, d√a = da/(2√a), d sin = cos·da), which the
// plain versions the kernels are held to use.
#pragma once

#include "rbd.cuh"

namespace grid {

using ::sqrt;  // keep the float and double overloads visible beside Dual's

template <typename T>
struct Dual {
  T v;  // value
  T t;  // tangent
  Dual() = default;
  __host__ __device__ Dual(T value) : v(value), t(T(0)) {}
  __host__ __device__ Dual(T value, T tangent) : v(value), t(tangent) {}
};

template <typename T>
struct Base<Dual<T>> {
  using type = T;
};

// ------------------------------------------------------------ dual ∘ dual
template <typename T>
__host__ __device__ __forceinline__ Dual<T> operator+(Dual<T> a, Dual<T> b) {
  return {a.v + b.v, a.t + b.t};
}
template <typename T>
__host__ __device__ __forceinline__ Dual<T> operator-(Dual<T> a, Dual<T> b) {
  return {a.v - b.v, a.t - b.t};
}
template <typename T>
__host__ __device__ __forceinline__ Dual<T> operator*(Dual<T> a, Dual<T> b) {
  return {a.v * b.v, a.t * b.v + a.v * b.t};
}
template <typename T>
__host__ __device__ __forceinline__ Dual<T> operator/(Dual<T> a, Dual<T> b) {
  const T q = a.v / b.v;
  return {q, (a.t - q * b.t) / b.v};
}
template <typename T>
__host__ __device__ __forceinline__ Dual<T> operator-(Dual<T> a) {
  return {-a.v, -a.t};
}

// ------------------------------------------------ dual ∘ constant, either side
template <typename T>
__host__ __device__ __forceinline__ Dual<T> operator+(Dual<T> a, T b) {
  return {a.v + b, a.t};
}
template <typename T>
__host__ __device__ __forceinline__ Dual<T> operator+(T a, Dual<T> b) {
  return {a + b.v, b.t};
}
template <typename T>
__host__ __device__ __forceinline__ Dual<T> operator-(Dual<T> a, T b) {
  return {a.v - b, a.t};
}
template <typename T>
__host__ __device__ __forceinline__ Dual<T> operator-(T a, Dual<T> b) {
  return {a - b.v, -b.t};
}
template <typename T>
__host__ __device__ __forceinline__ Dual<T> operator*(Dual<T> a, T b) {
  return {a.v * b, a.t * b};
}
template <typename T>
__host__ __device__ __forceinline__ Dual<T> operator*(T a, Dual<T> b) {
  return {a * b.v, a * b.t};
}
template <typename T>
__host__ __device__ __forceinline__ Dual<T> operator/(Dual<T> a, T b) {
  return {a.v / b, a.t / b};
}

template <typename T, typename U>
__host__ __device__ __forceinline__ Dual<T>& operator+=(Dual<T>& a, U b) {
  a = a + b;
  return a;
}
template <typename T, typename U>
__host__ __device__ __forceinline__ Dual<T>& operator-=(Dual<T>& a, U b) {
  a = a - b;
  return a;
}

// ---------------------------------------------------------------- functions
template <typename T>
__host__ __device__ __forceinline__ Dual<T> sqrt(Dual<T> a) {
  const T r = sqrt(a.v);
  return {r, a.t / (T(2) * r)};
}

template <typename T>
__device__ __forceinline__ void sincos_t(Dual<T> x, Dual<T>* s, Dual<T>* c) {
  T sv, cv;
  sincos_t(x.v, &sv, &cv);
  *s = Dual<T>(sv, cv * x.t);
  *c = Dual<T>(cv, -(sv * x.t));
}

}  // namespace grid
